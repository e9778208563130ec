"""The port's bulk similarity join (repro_torch.join) held against the
reference's (repro.join) case by case, as tests/test_join.py holds the
reference: the same index (the reference's, carried across by
``convert``) goes through both sweeps on the CPU. Rows agree within
BACKEND_ATOL (ids equal outside sets of scores within it) and lie
within the planned eps of exact SimRank; artifacts cross-load both
ways and both packages refuse the same bad bytes; a resumed sweep
equals an uninterrupted one bit for bit; checkpoints of another
configuration, of a future version or of the reference are refused;
a sweep dispatches one shape; and the engine's kNN lookups count and
refuse as the reference's do. The mesh cases are in
tests/test_torch_shard.py; the sampler cases wait for the port's GNN
stack.
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.core import update as rupdate
from repro.join import CKPT_FORMAT_VERSION as R_CKPT_VERSION
from repro.join import JoinConfig as RJoinConfig
from repro.join import KnnGraph as RKnnGraph
from repro.join import run_join as rrun_join
from repro.serve import EngineConfig as REngineConfig
from repro.serve import QueryEngine as RQueryEngine
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core import update as tupdate
from repro_torch.core.single_source import single_source_device
from repro_torch.join import (CKPT_FORMAT_VERSION, KNN_FORMAT_VERSION,
                              JoinConfig, KnnGraph, compile_count,
                              run_join)
from repro_torch.join import sweep as tsweep
from repro_torch.serve import EngineConfig, QueryEngine

pytestmark = pytest.mark.join

ATOL = oracle.BACKEND_ATOL
CASES = sorted(oracle.cases())
SETTINGS = [(0.4, 0.15), (0.6, 0.1), (0.8, 0.2)]
_cells: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's ops here are tiny and dispatch-bound: one intra-op
    thread keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carry(ri, g):
    """The reference index and graph as the port's objects (CPU)."""
    tg = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                   ri.hp.keys, ri.vals_f32(), ri.hp.counts,
                                   builder=ri.builder, device="cpu")
    return ti, tg


def _cell(name: str, c: float, eps: float):
    key = (name, c, eps)
    if key not in _cells:
        g = oracle.cases()[name]
        ri = rbuild.build_index(g, eps=eps, c=c, exact_d=True, seed=0)
        _cells[key] = (g, ri, *_carry(ri, g), oracle.exact_simrank(g, c))
    return _cells[key]


def _join(ti, tg, **kw):
    return run_join(ti, tg, device="cpu", **kw)


def _check_row(ids, sc, truth, k, tol):
    """tests/test_join.py's row check: scores descending, close to the
    exact sorted top-k, every returned node within tol of the exact
    k-th best (ties may swap ids)."""
    order = np.argsort(-truth, kind="stable")[:k]
    assert np.all(np.diff(sc) <= 1e-6)
    np.testing.assert_allclose(sc, truth[order], atol=tol)
    kth = truth[order[-1]]
    assert np.all(truth[ids] >= kth - tol), (ids, truth[ids], kth)
    np.testing.assert_allclose(sc, truth[ids], atol=tol)


def _agree(t, r, ti, tg):
    """Port artifact ``t`` vs reference artifact ``r`` over one source
    set: the same CSR shape and flags, scores within BACKEND_ATOL, and
    ids equal except where the two ids' scores (the port's dense
    single-source rows) are within BACKEND_ATOL of each other."""
    np.testing.assert_array_equal(t.sources, r.sources)
    np.testing.assert_array_equal(t.indptr, r.indptr)
    np.testing.assert_allclose(t.nbr_scores, r.nbr_scores, atol=ATOL,
                               rtol=0)
    if r.truncated is None:
        assert t.truncated is None
    else:
        np.testing.assert_array_equal(t.truncated, r.truncated)
    assert (t.mode, t.k, t.tau, t.exclude_self, t.tile, t.epoch, t.n) == \
        (r.mode, r.k, r.tau, r.exclude_self, r.tile, r.epoch, r.n)
    assert (t.eps, t.c, t.theta, t.l_max) == (r.eps, r.c, r.theta, r.l_max)
    diff = np.flatnonzero(t.nbr_ids != r.nbr_ids)
    if len(diff):
        full = single_source_device(ti, tg, t.sources, device="cpu")
        rows = np.repeat(np.arange(len(t.sources)), np.diff(t.indptr))[diff]
        gap = np.abs(full[rows, t.nbr_ids[diff]]
                     - full[rows, r.nbr_ids[diff]])
        assert gap.max() <= ATOL, gap.max()


# ----------------------------------------------------------------------
# differential: all-sources top-k over the zoo x c sweep
# ----------------------------------------------------------------------
@pytest.mark.parametrize("c,eps", SETTINGS)
@pytest.mark.parametrize("name", CASES)
def test_join_topk_matches_reference_and_exact_oracle(name, c, eps):
    g, ri, ti, tg, S = _cell(name, c, eps)
    tol = oracle.tolerance(ri.plan)
    k = 8
    knn = _join(ti, tg, config=JoinConfig(k=k, tile=16))
    ref = rrun_join(ri, g, config=RJoinConfig(k=k, tile=16))
    _agree(knn, ref, ti, tg)
    assert knn.sources.tolist() == list(range(g.n))
    assert knn.epoch == ti.epoch and knn.eps == ti.plan.eps
    assert knn.mesh_shards == 1
    for u in range(g.n):
        ids, sc = knn.neighbors(u)
        assert len(ids) == min(k, g.n)
        _check_row(ids, sc, S[u], min(k, g.n), tol)


@pytest.mark.parametrize("name", ["er", "sinks"])
def test_join_threshold_matches_reference_and_exact_oracle(name):
    """sim >= tau with cap = n: the row set brackets the exact threshold
    set and nothing is flagged, as the reference's sweep does."""
    g, ri, ti, tg, S = _cell(name, 0.6, 0.1)
    tol = oracle.tolerance(ri.plan)
    tau = 0.08
    knn = _join(ti, tg, config=JoinConfig(tau=tau, cap=g.n, tile=16))
    ref = rrun_join(ri, g, config=RJoinConfig(tau=tau, cap=g.n, tile=16))
    _agree(knn, ref, ti, tg)
    assert knn.mode == "threshold" and not knn.truncated.any()
    for u in range(g.n):
        ids, sc = knn.neighbors(u)
        assert np.all(sc >= tau)
        np.testing.assert_allclose(sc, S[u][ids], atol=tol)
        got = set(ids.tolist())
        must = set(np.flatnonzero(S[u] >= tau + tol).tolist())
        may = set(np.flatnonzero(S[u] >= tau - tol).tolist())
        assert must <= got <= may, (u, must - got, got - may)


@pytest.fixture(scope="module")
def carried(small_graph, sling_index):
    """conftest.py's 150-node reference index, carried to the port."""
    ti, tg = _carry(sling_index, small_graph)
    return sling_index, small_graph, ti, tg


def test_threshold_truncation_is_flagged(carried):
    """A cap below the match count flags the row (full: cap entries, all
    >= tau) as the reference flags it; a big cap resolves it."""
    ri, g, ti, tg = carried
    small = _join(ti, tg, config=JoinConfig(tau=0.0, cap=4, tile=32))
    rsmall = rrun_join(ri, g, config=RJoinConfig(tau=0.0, cap=4, tile=32))
    assert small.truncated.all()
    assert np.all(np.diff(small.indptr) == 4)
    _agree(small, rsmall, ti, tg)
    big = _join(ti, tg, config=JoinConfig(tau=0.2, cap=g.n, tile=32))
    rbig = rrun_join(ri, g, config=RJoinConfig(tau=0.2, cap=g.n, tile=32))
    assert not big.truncated.any()
    _agree(big, rbig, ti, tg)


# ----------------------------------------------------------------------
# the artifact (INDEX_FORMAT.md "KnnGraph artifact"), both packages
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def knn150(carried):
    _, _, ti, tg = carried
    return _join(ti, tg, config=JoinConfig(k=8, tile=32))


@pytest.fixture(scope="module")
def rknn150(carried):
    ri, g, _, _ = carried
    return rrun_join(ri, g, config=RJoinConfig(k=8, tile=32))


def test_join_matches_reference_on_150_nodes(carried, knn150, rknn150):
    _agree(knn150, rknn150, carried[2], carried[3])


def _same_artifact(a, b) -> None:
    for f in ("sources", "indptr", "nbr_ids", "nbr_scores"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.truncated is None) == (b.truncated is None)
    if a.truncated is not None:
        np.testing.assert_array_equal(a.truncated, b.truncated)
    for f in ("n", "mode", "k", "tau", "exclude_self", "tile", "eps", "c",
              "theta", "l_max", "epoch", "mesh_shards"):
        assert getattr(a, f) == getattr(b, f), f


def test_artifact_roundtrip(tmp_path, knn150):
    path = str(tmp_path / "knn.npz")
    knn150.save(path)
    assert not os.path.exists(path + ".tmp")
    back = KnnGraph.load(path)
    _same_artifact(back, knn150)
    for u in (0, 7, 149):
        ids_a, sc_a = back.neighbors(u)
        ids_b, sc_b = knn150.neighbors(u)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_array_equal(sc_a, sc_b)
    assert back.nnz == 150 * 8 and back.nbytes() == knn150.nbytes()


@pytest.mark.parametrize("mode", ["topk", "threshold"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_artifact_cross_loads(tmp_path, carried, writer, mode):
    """Each package loads the other's file to the same arrays and meta."""
    ri, g, ti, tg = carried
    kw = dict(tau=0.1, cap=12) if mode == "threshold" else dict(k=6)
    if writer == "port":
        made = _join(ti, tg, config=JoinConfig(tile=32, **kw))
        loader = RKnnGraph.load
    else:
        made = rrun_join(ri, g, config=RJoinConfig(tile=32, **kw))
        loader = KnnGraph.load
    path = str(tmp_path / "knn.npz")
    made.save(path)
    _same_artifact(loader(path), made)


def _rewrite(src: str, dst: str, arrays=None, **changes) -> None:
    with np.load(src, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        members = {k: z[k] for k in z.files if k != "meta"}
    meta.update(changes)
    members.update(arrays or {})
    with open(dst, "wb") as f:
        np.savez_compressed(f, meta=json.dumps(meta), **members)


def _bad_files(knn):
    """{case: (meta changes, member changes, refusal message)}."""
    src, ind = knn.sources.copy(), knn.indptr.copy()
    neg, past, dup = src.copy(), src.copy(), src.copy()
    neg[0], past[0], dup[1] = -1, knn.n, dup[0]
    bumpy = ind.copy()
    bumpy[2] = bumpy[3] + 1
    ids = knn.nbr_ids.copy()
    ids[5] = knn.n
    return {
        "future-version": ({"_format_version": KNN_FORMAT_VERSION + 1},
                           {}, "format v"),
        "unknown-meta": ({"score_scale": 2.0}, {}, "unknown fields"),
        "negative-source": ({}, {"sources": neg}, "source id outside"),
        "source-past-n": ({}, {"sources": past}, "source id outside"),
        "empty-sources": ({}, {"sources": src[:0], "indptr": ind[:1],
                               "nbr_ids": knn.nbr_ids[:0],
                               "nbr_scores": knn.nbr_scores[:0]},
                          "source id outside"),
        "duplicate-sources": ({}, {"sources": dup}, "not unique"),
        "indptr-length": ({}, {"indptr": ind[:-1]}, "inconsistent"),
        "indptr-start": ({}, {"indptr": ind + 1}, "inconsistent"),
        "ids-vs-scores": ({}, {"nbr_scores": knn.nbr_scores[:-1]},
                          "inconsistent"),
        "non-monotone": ({}, {"indptr": bumpy}, "not monotone"),
        "neighbor-past-n": ({}, {"nbr_ids": ids}, "neighbor id outside"),
    }


BAD_FILES = ("future-version", "unknown-meta", "negative-source",
             "source-past-n", "empty-sources", "duplicate-sources",
             "indptr-length", "indptr-start", "ids-vs-scores",
             "non-monotone", "neighbor-past-n")


@pytest.mark.parametrize("case", BAD_FILES)
def test_artifact_refusals_match_reference(tmp_path, knn150, case):
    """Every refusal of the reference's ``load``, on the same bytes, in
    both packages."""
    path = str(tmp_path / "knn.npz")
    knn150.save(path)
    meta, members, match = _bad_files(knn150)[case]
    bad = str(tmp_path / "bad.npz")
    _rewrite(path, bad, members, **meta)
    with pytest.raises(ValueError, match=match):
        KnnGraph.load(bad)
    with pytest.raises(ValueError, match=match):
        RKnnGraph.load(bad)


def test_artifact_lookup_outside_sources_raises(carried):
    ri, g, ti, tg = carried
    subset = np.array([3, 9, 77], np.int32)
    knn = _join(ti, tg, sources=subset, config=JoinConfig(k=4, tile=4))
    ref = rrun_join(ri, g, sources=subset, config=RJoinConfig(k=4, tile=4))
    _agree(knn, ref, ti, tg)
    assert knn.has(9) and not knn.has(4) and not knn.has(-1)
    knn.neighbors(9)
    with pytest.raises(KeyError):
        knn.neighbors(4)
    with pytest.raises(ValueError, match="unique"):
        _join(ti, tg, sources=[3, 3], config=JoinConfig(k=4))
    with pytest.raises(ValueError, match="outside"):
        _join(ti, tg, sources=[g.n], config=JoinConfig(k=4))
    with pytest.raises(ValueError, match="empty"):
        _join(ti, tg, sources=[], config=JoinConfig(k=4))


def test_exclude_self(carried, knn150):
    ri, g, ti, tg = carried
    knn = _join(ti, tg, config=JoinConfig(k=8, tile=32, exclude_self=True))
    ref = rrun_join(ri, g, config=RJoinConfig(k=8, tile=32,
                                              exclude_self=True))
    _agree(knn, ref, ti, tg)
    for u in (0, 50, 149):
        ids, sc = knn.neighbors(u)
        assert u not in ids and len(ids) == 8
        # prefix agreement with the self-including sweep (which holds
        # one fewer non-self candidate: it fetched k, not k + 1)
        ids_all, _ = knn150.neighbors(u)
        keep = ids_all[ids_all != u]
        np.testing.assert_array_equal(ids[:len(keep)], keep)


# ----------------------------------------------------------------------
# checkpoint / resume (tile-granular, bit-stable)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stop", [1, 2, 4])
def test_resume_equals_uninterrupted(tmp_path, carried, knn150, stop):
    _, _, ti, tg = carried
    ck = str(tmp_path / "sweep.ckpt.npz")
    cfg = JoinConfig(k=8, tile=32, checkpoint_path=ck, checkpoint_every=1)
    assert _join(ti, tg, config=cfg, stop_after_tiles=stop) is None
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp")
    resumed = _join(ti, tg, config=cfg)
    assert not os.path.exists(ck)   # complete sweeps clear their state
    _same_artifact(resumed, knn150)


def test_resume_of_a_threshold_sweep_equals_uninterrupted(tmp_path,
                                                          carried):
    _, _, ti, tg = carried
    cfg = JoinConfig(tau=0.05, cap=16, tile=16, exclude_self=True)
    full = _join(ti, tg, config=cfg)
    ck = str(tmp_path / "t.ckpt.npz")
    part = dataclasses.replace(cfg, checkpoint_path=ck, checkpoint_every=3)
    assert _join(ti, tg, config=part, stop_after_tiles=5) is None
    _same_artifact(_join(ti, tg, config=part), full)


def test_resume_refuses_mismatched_fingerprint(tmp_path, carried):
    _, g, ti, tg = carried
    ck = str(tmp_path / "sweep.ckpt.npz")
    cfg = JoinConfig(k=8, tile=32, checkpoint_path=ck, checkpoint_every=1)
    assert _join(ti, tg, config=cfg, stop_after_tiles=1) is None
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _join(ti, tg, config=JoinConfig(k=4, tile=32, checkpoint_path=ck))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        # the same sweep on the other push backend sums in another order
        _join(ti, tg, config=dataclasses.replace(cfg,
                                                 push_backend="kernel"))
    with pytest.raises(ValueError, match="source set"):
        # same count (fingerprint-identical), different node ids
        _join(ti, tg, sources=np.arange(g.n, dtype=np.int32)[::-1],
              config=JoinConfig(k=8, tile=32, checkpoint_path=ck))


def test_checkpoint_refuses_future_version(tmp_path, carried):
    _, _, ti, tg = carried
    ck = str(tmp_path / "sweep.ckpt.npz")
    cfg = JoinConfig(k=8, tile=32, checkpoint_path=ck, checkpoint_every=1)
    assert _join(ti, tg, config=cfg, stop_after_tiles=1) is None
    bad = str(tmp_path / "future.ckpt.npz")
    _rewrite(ck, bad, _format_version=CKPT_FORMAT_VERSION + 1)
    with pytest.raises(ValueError, match="format v"):
        _join(ti, tg, config=JoinConfig(k=8, tile=32, checkpoint_path=bad))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_the_other_packages_checkpoint_is_refused(tmp_path, carried,
                                                  writer):
    """The reference records the push backend as "lax" or "pallas" and
    the port as "plain" or "kernel": their float orders differ, so a
    checkpoint of one package is refused by the other, never resumed."""
    ri, g, ti, tg = carried
    assert CKPT_FORMAT_VERSION == R_CKPT_VERSION
    ck = str(tmp_path / "sweep.ckpt.npz")
    kw = dict(k=8, tile=32, checkpoint_path=ck, checkpoint_every=1)
    if writer == "reference":
        assert rrun_join(ri, g, config=RJoinConfig(**kw),
                         stop_after_tiles=1) is None
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            _join(ti, tg, config=JoinConfig(**kw))
    else:
        assert _join(ti, tg, config=JoinConfig(**kw),
                     stop_after_tiles=1) is None
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            rrun_join(ri, g, config=RJoinConfig(**kw))
    assert os.path.exists(ck)   # refused, not consumed


# ----------------------------------------------------------------------
# one dispatch shape a sweep (the port's fixed-shape rule)
# ----------------------------------------------------------------------
def test_one_dispatched_shape_a_sweep(carried):
    _, g, ti, tg = carried
    cfg = JoinConfig(k=8, tile=16)
    _join(ti, tg, sources=np.arange(16, dtype=np.int32), config=cfg)
    before, c0 = set(tsweep._shapes), compile_count()
    assert (16, 8, "plain") in before
    knn = _join(ti, tg, config=cfg)   # 10 tiles
    _join(ti, tg, sources=np.arange(40, 90, dtype=np.int32), config=cfg)
    assert tsweep._shapes == before and compile_count() == c0
    assert len(knn.sources) == g.n
    _join(ti, tg, config=JoinConfig(k=8, tile=16, exclude_self=True))
    assert compile_count() == c0 + 1
    assert tsweep._shapes - before == {(16, 9, "plain")}


def test_run_join_and_the_frontend_default_to_the_card(monkeypatch,
                                                     carried):
    """No silent CPU fallback: without a card and without device="cpu"
    the sweep and the frontend's engines raise."""
    from repro_torch.serve import FrontendConfig, ServeFrontend
    _, _, ti, tg = carried
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_join(ti, tg, config=JoinConfig(k=4))
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeFrontend(ti, tg, FrontendConfig(replicas=2))
    assert threading.active_count() == before   # no timer thread left


def test_mesh_waits_for_sharding(carried):
    """The port's sharding has come: ``JoinConfig(mesh=)`` sweeps through
    the node-sharded fan-out, rows equal to the one-device sweep's, and
    records the shard count in the artifact."""
    from repro_torch.core.shard_query import serving_mesh
    _, _, ti, tg = carried
    one = _join(ti, tg, config=JoinConfig(k=8, tile=32))
    mesh = serving_mesh(2, devices=["cpu", "cpu"])
    two = run_join(ti, tg, config=JoinConfig(k=8, tile=32, mesh=mesh))
    assert (one.mesh_shards, two.mesh_shards) == (1, 2)
    np.testing.assert_array_equal(two.nbr_ids, one.nbr_ids)
    np.testing.assert_allclose(two.nbr_scores, one.nbr_scores, atol=ATOL,
                               rtol=0)


# ----------------------------------------------------------------------
# the engine's kNN lookups, beside the reference engine's
# ----------------------------------------------------------------------
def test_engine_knn_lookup_and_staleness(small_graph):
    g = small_graph
    ri = rbuild.build_index(g, eps=0.1, exact_d=True, seed=0)
    ti, tg = _carry(ri, g)
    knn = _join(ti, tg, config=JoinConfig(k=8, tile=32))
    rknn = rrun_join(ri, g, config=RJoinConfig(k=8, tile=32))
    eng = QueryEngine(ti, tg, EngineConfig(source_batch=4), device="cpu")
    reng = RQueryEngine(ri, g, REngineConfig(source_batch=4))
    for e in (eng, reng):
        with pytest.raises(RuntimeError, match="no KnnGraph"):
            e.knn(3)
    eng.attach_knn(knn)
    reng.attach_knn(rknn)
    ids, sc = eng.knn(3)
    ids_a, sc_a = knn.neighbors(3)
    np.testing.assert_array_equal(ids, ids_a)
    np.testing.assert_array_equal(sc, sc_a)
    rids, rsc = reng.knn(3)
    np.testing.assert_allclose(sc, rsc, atol=ATOL)
    ids_k, _ = eng.knn(3, k=2)
    np.testing.assert_array_equal(ids_k, ids_a[:2])
    reng.knn(3, k=2)
    # a hot-swap moves the served epoch past the artifact's: lookups
    # refuse rather than serve pre-swap scores
    delta = tupdate.random_delta(tg, n_add=6, n_del=6, seed=2)
    rdelta = rupdate.random_delta(g, n_add=6, n_del=6, seed=2)
    rep = tbuild.update_index(ti, tg, delta, exact_d=True)
    rrep = rbuild.update_index(ri, g, rdelta, exact_d=True)
    eng.swap_index(ti, rep.graph, affected=rep.affected)
    reng.swap_index(ri, rrep.graph, affected=rrep.affected)
    for e in (eng, reng):
        with pytest.raises(RuntimeError, match="stale"):
            e.knn(3)
        e.knn(3, allow_stale=True)     # explicit opt-in still works
    st, rst = eng.stats(), reng.stats()
    assert st["knn"] == rst["knn"] == 5
    assert st["knn_stale_rejects"] == rst["knn_stale_rejects"] == 1
    assert st["knn_attached"] and rst["knn_attached"]
    # re-attaching the stale artifact needs the same opt-in; a fresh
    # join at the new epoch attaches cleanly
    with pytest.raises(ValueError, match="epoch"):
        eng.attach_knn(knn)
    eng.attach_knn(knn, allow_stale=True)
    fresh = _join(ti, rep.graph, config=JoinConfig(k=8, tile=32))
    assert fresh.epoch == ti.epoch == knn.epoch + 1
    eng.attach_knn(fresh)
    eng.knn(3)
    rfresh = rrun_join(ri, rrep.graph, config=RJoinConfig(k=8, tile=32))
    _agree(fresh, rfresh, ti, rep.graph)


def test_engine_serves_the_reference_artifact(tmp_path, carried, rknn150):
    """A file the reference's sweep wrote, loaded by the port and
    attached to the port's engine over the same index."""
    _, _, ti, tg = carried
    path = str(tmp_path / "ref.npz")
    rknn150.save(path)
    eng = QueryEngine(ti, tg, device="cpu")
    eng.attach_knn(KnnGraph.load(path))
    for u in (0, 77, 149):
        ids, sc = eng.knn(u)
        rids, rsc = rknn150.neighbors(u)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(sc, rsc)


def test_engine_knn_rejects_wrong_graph(carried):
    from repro_torch.graph import generators
    _, _, ti, tg = carried
    g2 = generators.erdos_renyi(32, 90, seed=0, directed=True)
    idx2 = tbuild.build_index(g2, eps=0.2, exact_d=True, seed=0,
                              device="cpu")
    knn2 = _join(idx2, g2, config=JoinConfig(k=4, tile=16))
    eng = QueryEngine(ti, tg, device="cpu")
    with pytest.raises(ValueError, match="n="):
        eng.attach_knn(knn2)
