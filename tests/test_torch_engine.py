"""The port's QueryEngine held against the reference QueryEngine on the
same index (carried across by ``convert``), against exact SimRank on the
oracle zoo, and to the reference's dispatch contract: fixed shapes after
warmup, k-buckets, the LRU cache, ties to the smaller id, and the
uncertified-diagonal refusal. Plus the serving CLI on the CPU."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.serve import EngineConfig as REngineConfig
from repro.serve import QueryEngine as RQueryEngine
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core.topk import stable_topk, topk_host
from repro_torch.serve import EngineConfig, QueryEngine

ATOL = oracle.BACKEND_ATOL
ROOT = Path(__file__).resolve().parent.parent


def _carry(ri, g):
    """The reference index and graph as the port's objects (CPU)."""
    tg = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                   ri.hp.keys, ri.vals_f32(), ri.hp.counts,
                                   builder=ri.builder, device="cpu")
    return ti, tg


@pytest.fixture(scope="module")
def carried():
    g = oracle.cases()["powerlaw"]
    ri = rbuild.build_index(g, eps=0.1, exact_d=True)
    ti, tg = _carry(ri, g)
    return ri, g, ti, tg


def _engines(carried, **cfg):
    ri, g, ti, tg = carried
    reng = RQueryEngine(ri, g, REngineConfig(source_batch=4, pair_batch=32,
                                             cache_size=0))
    teng = QueryEngine(ti, tg, EngineConfig(source_batch=4, pair_batch=32,
                                            cache_size=0, **cfg),
                       device="cpu")
    return reng, teng


@pytest.mark.parametrize("pair_backend", ["join", "kernel"])
def test_pairs_match_reference_engine(carried, pair_backend):
    reng, teng = _engines(carried, pair_backend=pair_backend)
    n = carried[0].n
    rng = np.random.default_rng(1)
    us, vs = rng.integers(0, n, 100), rng.integers(0, n, 100)
    np.testing.assert_allclose(teng.pairs(us, vs), reng.pairs(us, vs),
                               atol=ATOL, rtol=0)
    assert teng.stats()["pair_backend"] == pair_backend


@pytest.mark.parametrize("push_backend", ["plain", "kernel"])
def test_single_source_matches_reference_engine(carried, push_backend):
    reng, teng = _engines(carried, push_backend=push_backend)
    us = [0, 5, 17, 33, 63, 5, 40]
    np.testing.assert_allclose(teng.single_source(us),
                               reng.single_source(us), atol=ATOL, rtol=0)


def _check_topk(sv, si, ref_scores, k):
    """Top-k answer vs dense scores, up to near-ties (tests/test_topk.py)."""
    order = np.argsort(-ref_scores, kind="stable")[:k]
    assert np.all(np.diff(sv) <= 1e-6)
    np.testing.assert_allclose(sv, ref_scores[order], atol=ATOL)
    assert np.all(ref_scores[si] >= ref_scores[order[-1]] - ATOL)
    np.testing.assert_allclose(sv, ref_scores[si], atol=ATOL)


@pytest.mark.parametrize("k", [1, 10, 64])
def test_topk_matches_reference_engine(carried, k):
    reng, teng = _engines(carried)
    us = [2, 9, 30, 61, 7]
    tv, ti = teng.topk(us, k)
    rv, ri_ = reng.topk(us, k)
    assert tv.shape == rv.shape == (len(us), min(k, 64))
    np.testing.assert_allclose(tv, rv, atol=ATOL, rtol=0)
    dense = reng.single_source(us)
    for b in range(len(us)):
        _check_topk(tv[b], ti[b], dense[b], min(k, 64))
        # ids agree wherever the reference's scores are not near-tied
        gap = np.abs(np.diff(rv[b]))
        clear = np.concatenate([[True], gap > ATOL]) & \
            np.concatenate([gap > ATOL, [True]])
        np.testing.assert_array_equal(ti[b][clear], ri_[b][clear])


def test_host_references_agree_with_engine(carried):
    ri, g, ti, tg = carried
    teng = QueryEngine(ti, tg, EngineConfig(cache_size=0), device="cpu")
    from repro_torch.core.single_source import single_source_horner
    for u in (1, 20, 50):
        np.testing.assert_allclose(teng.single_source([u])[0],
                                   single_source_horner(ti, tg, u),
                                   atol=ATOL, rtol=0)
        v, i = topk_host(ti, tg, u, 5)
        _check_topk(teng.topk([u], 5)[0][0], teng.topk([u], 5)[1][0],
                    single_source_horner(ti, tg, u), 5)
        assert i[0] == u


def test_planted_ties_go_to_smaller_id():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    v, i = stable_topk(scores, 4)
    assert i.tolist() == [[1, 3, 0, 2], [0, 1, 2, 3]]
    assert i.dtype == torch.int32
    # a star: from spoke 5 every other spoke scores exactly the same
    from repro_torch.graph import csr
    star = csr.undirected(12, np.zeros(11, np.int64), np.arange(1, 12))
    idx = tbuild.build_index(star, eps=0.1, exact_d=True, device="cpu")
    for backend in ("plain", "kernel"):
        eng = QueryEngine(idx, star, EngineConfig(push_backend=backend),
                          device="cpu")
        sv, si = eng.topk([5], 11)
        assert si[0][0] == 5
        spokes = [int(x) for x in si[0][1:] if x != 0]
        assert len(spokes) == 10 and len({float(eng.single_source([5])[0][x])
                                         for x in spokes}) == 1
        assert spokes == [1, 2, 3, 4, 6, 7, 8, 9, 10, 11]


def test_fixed_shape_set_after_warmup(carried):
    _, _, ti, tg = carried
    eng = QueryEngine(ti, tg, EngineConfig(source_batch=4, pair_batch=16,
                                           k_buckets=(1, 8, 32)),
                      device="cpu")
    warm = eng.warmup()
    assert set(warm) >= {"pair", "source", "topk@1", "topk@8", "topk@32",
                         "topk@64"}
    st = eng.stats()
    shapes = st["unique_shapes"]
    assert st["batches"] == 0 and st["warmup_batches"] > 0
    rng = np.random.default_rng(0)
    for size in (1, 3, 4, 5, 17, 40):
        q = rng.integers(0, ti.n, size)
        eng.pairs(q, q[::-1])
        eng.single_source(q)
        for k in (1, 5, 8, 20, 33, 64, 500):
            eng.topk(q, k)
    st = eng.stats()
    assert st["unique_shapes"] == shapes
    assert st["batches"] > 0 and st["pad_slots"] > 0


def test_width_bucket_follows_headroom_and_quantum():
    """``EngineConfig(swap_headroom=, cap_quantum=)`` sizes the width
    bucket as the reference's engine does with the same config: at
    install, after a swap that fits the bucket, and after one that grows
    it (eps 0.1 -> 0.05 -> 0.02 widens the packed rows)."""
    g = oracle.cases()["powerlaw"]
    ris = [rbuild.build_index(g, eps=e, exact_d=True)
           for e in (0.1, 0.05, 0.02)]
    tis = [_carry(ri, g) for ri in ris]
    kw = dict(swap_headroom=2.0, cap_quantum=32, source_batch=4,
              pair_batch=32)
    reng = RQueryEngine(ris[0], g, REngineConfig(**kw))
    teng = QueryEngine(*tis[0], EngineConfig(**kw), device="cpu")
    default = QueryEngine(*tis[0], device="cpu")
    assert teng._width_cap == reng._width_cap
    assert default._width_cap != teng._width_cap
    caps = [teng._width_cap]
    for ri, (ti, tg) in zip(ris[1:], tis[1:]):
        rs = reng.swap_index(ri, g)
        ts = teng.swap_index(ti, tg)
        assert teng._width_cap == reng._width_cap
        assert ts["recompiles"] == rs["recompiles"]
        assert teng.stats()["width_cap"] == teng._width_cap
        caps.append(teng._width_cap)
    # the first swap fits the bucket, the second grows it
    assert caps[0] == caps[1] < caps[2]
    assert teng.stats()["swap_recompiles"] == \
        reng.stats()["swap_recompiles"]


def test_lru_hits_are_counted(carried):
    _, _, ti, tg = carried
    eng = QueryEngine(ti, tg, EngineConfig(cache_size=64), device="cpu")
    a = eng.pairs([3, 4], [10, 11])
    b = eng.pairs([10, 11], [3, 4])          # symmetric key
    np.testing.assert_array_equal(a, b)
    s1 = eng.single_source([7, 8])
    s2 = eng.single_source([8])
    np.testing.assert_array_equal(s1[1], s2[0])
    t1 = eng.topk([7], 5)
    t2 = eng.topk([7], 3)                    # same k-bucket
    np.testing.assert_array_equal(t1[1][0][:3], t2[1][0])
    st = eng.stats()
    assert st["cache_hits_by_kind"] == {"pair": 2, "src": 1, "topk": 1}
    assert st["cache_hits"] == 4 and st["cache_entries"] == 5


def test_uncertified_index_is_refused(carried):
    ri, g, _, tg = carried
    ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                   ri.hp.keys, ri.vals_f32(), ri.hp.counts,
                                   uncertified_d=True, device="cpu")
    with pytest.raises(ValueError, match="uncertified"):
        QueryEngine(ti, tg, device="cpu")
    eng = QueryEngine(ti, tg, EngineConfig(allow_uncertified=True),
                      device="cpu")
    assert eng.pair(1, 2) >= 0.0


def test_engine_refuses_missing_card(carried, monkeypatch):
    _, _, ti, tg = carried
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(ti, tg)
    with pytest.raises(ValueError, match="pair backend"):
        QueryEngine(ti, tg, EngineConfig(pair_backend="pallas"),
                    device="cpu")


@pytest.mark.parametrize("name", tuple(oracle.cases()))
def test_answers_within_eps_of_exact_simrank(name):
    r = oracle.cases()[name]
    g = convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)
    idx = tbuild.build_index(g, eps=0.1, exact_d=True, device="cpu")
    S = oracle.exact_simrank(r, 0.6)
    tol = oracle.tolerance(idx.plan)
    n = g.n
    for pb in ("join", "kernel"):
        eng = QueryEngine(idx, g, EngineConfig(pair_backend=pb,
                                               cache_size=0), device="cpu")
        uu, vv = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        got = eng.pairs(uu.ravel(), vv.ravel()).reshape(n, n)
        assert np.abs(got - S).max() <= tol
    eng = QueryEngine(idx, g, EngineConfig(cache_size=0), device="cpu")
    src = eng.single_source(np.arange(n))
    assert np.abs(src - S).max() <= tol
    sv, si = eng.topk(np.arange(n), 10)
    for u in range(n):
        np.testing.assert_allclose(sv[u], S[u][si[u]], atol=tol)
        kth = np.sort(S[u])[::-1][min(10, n) - 1]
        assert np.all(S[u][si[u]] >= kth - 2 * tol)


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--n", "200", "--queries", "8", "--mode", "mixed"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "0 new after warmup (fixed shape set OK)" in out.stdout
    for mode in ("source", "pair", "topk"):
        assert f"[{mode}] 8 queries" in out.stdout
