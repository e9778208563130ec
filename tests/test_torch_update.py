"""The port's dynamic-graph path held against the JAX reference on the
oracle zoo: ``apply_edges``, ``random_delta``, the staleness plan, the
pull and push mass scans, ``repair_hp_rows`` and ``update_index`` (on
one index carried across with ``convert``), the subset diagonal, and
the engine's hot-swap and cache invalidation."""
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
from repro.core import hp_index as rhp
from repro.core import theory as rtheory
from repro.core import update as rupdate
from repro.graph import csr as rcsr
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core import diagonal as tdiagonal
from repro_torch.core import hp_index as thp
from repro_torch.core import theory as ttheory
from repro_torch.core import update as tupdate
from repro_torch.core.single_source import single_source_horner
from repro_torch.graph import csr as tcsr
from repro_torch.serve import EngineConfig, QueryEngine

ZOO = tuple(oracle.cases())
ATOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
CSR_FIELDS = ("n", "m", "in_ptr", "in_idx", "out_ptr", "out_idx",
              "edge_dst", "edge_src")


def _graphs(name):
    r = oracle.cases()[name]
    return r, convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)


def _tdelta(d):
    """The reference's delta as the port's."""
    return tcsr.GraphDelta(d.add_src, d.add_dst, d.del_src, d.del_dst)


def _carry(ri):
    return convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                     ri.hp.keys, ri.vals_f32(),
                                     ri.hp.counts, device="cpu")


def _entries(keys, vals, counts, rows=None, targets=None, n=None):
    """{(row, key): value} of a packed table, optionally only rows in
    ``rows`` and keys whose target is in ``targets``."""
    live = np.arange(keys.shape[1])[None, :] < counts[:, None]
    r, c = np.nonzero(live)
    out = {}
    tset = None if targets is None else set(np.asarray(targets).tolist())
    rset = None if rows is None else set(np.asarray(rows).tolist())
    for i, j in zip(r.tolist(), c.tolist()):
        k = int(keys[i, j])
        if (rset is None or i in rset) and \
                (tset is None or k % n in tset):
            out[(i, k)] = float(vals[i, j])
    return out


def _assert_tables_match(got, ref, theta, **sel):
    """Keys equal and values within ATOL; an entry on one side only must
    sit within float32 rounding of theta (counted, never hidden)."""
    e_got = _entries(got.keys.numpy(), got.vals.numpy(), got.counts.numpy(),
                     **sel)
    e_ref = _entries(np.asarray(ref.keys), np.asarray(ref.vals),
                     np.asarray(ref.counts), **sel)
    only = [(k, v) for k, v in e_ref.items() if k not in e_got] + \
        [(k, v) for k, v in e_got.items() if k not in e_ref]
    assert all(abs(v - theta) <= 4e-7 * theta for _, v in only), only
    shared = [k for k in e_ref if k in e_got]
    np.testing.assert_allclose([e_got[k] for k in shared],
                               [e_ref[k] for k in shared], atol=ATOL, rtol=0)
    return len(only)


# ----------------------------------------------------------------------
# graph layer: GraphDelta / apply_edges / random_delta
# ----------------------------------------------------------------------
def _toy():
    #  0 -> 1, 0 -> 2, 1 -> 2, 3 -> 0, and a parallel 1 -> 2
    return [0, 0, 1, 3, 1], [1, 2, 2, 0, 2]


DELTAS = {
    "insert-delete": ([2], [3], [0], [2]),
    "noops": ([0], [1], [2], [0]),            # exists / never existed
    "same-edge-both": ([2], [3], [2], [3]),   # cancels out
    "duplicates": ([2, 2, 3], [3, 3, 1], [0, 0], [1, 1]),
    "delete-parallel-edge": ([], [], [1], [2]),
    "inserts-only": ([3, 2, 1], [1, 0, 3], [], []),
}


@pytest.mark.parametrize("name", DELTAS)
def test_apply_edges_matches_reference(name):
    src, dst = _toy()
    r = rcsr.from_edges(4, np.array(src), np.array(dst), dedup=False)
    t = convert.graph_from_arrays(4, src, dst)
    a_s, a_d, d_s, d_d = (np.asarray(x, np.int64) for x in DELTAS[name])
    rd = rcsr.GraphDelta(a_s, a_d, d_s, d_d)
    r2, r_touched, r_tv = rcsr.apply_edges(r, rd)
    t2, t_touched, t_tv = tcsr.apply_edges(t, _tdelta(rd))
    for f in CSR_FIELDS:
        x, y = getattr(t2, f), getattr(r2, f)
        assert np.array_equal(x, y), f
    np.testing.assert_array_equal(t_touched, r_touched)
    np.testing.assert_array_equal(t_tv, r_tv)
    if name in ("noops", "same-edge-both"):
        assert len(t_touched) == 0 and t2 is t


def test_apply_edges_refuses_out_of_range_ids():
    src, dst = _toy()
    t = convert.graph_from_arrays(4, src, dst)
    for bad in (tcsr.GraphDelta.inserts([0], [7]),
                tcsr.GraphDelta.deletes([0], [6]),
                tcsr.GraphDelta.deletes([-1], [0])):
        with pytest.raises(ValueError, match="outside"):
            tcsr.apply_edges(t, bad)
    assert len(tcsr.GraphDelta.empty()) == 0


@pytest.mark.parametrize("name", ZOO)
def test_random_delta_matches_reference(name):
    r, t = _graphs(name)
    rd = rupdate.random_delta(r, n_add=9, n_del=7, seed=3)
    td = tupdate.random_delta(t, n_add=9, n_del=7, seed=3)
    for f in ("add_src", "add_dst", "del_src", "del_dst"):
        np.testing.assert_array_equal(getattr(td, f), getattr(rd, f))


# ----------------------------------------------------------------------
# plan and staleness accounting
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stale_frac", [0.0, 0.2, 0.5])
def test_plan_with_stale_frac_matches_reference(stale_frac):
    for eps, c, n in ((0.025, 0.6, 36_692), (0.1, 0.6, 64), (0.2, 0.8, 40)):
        t = ttheory.plan(eps=eps, c=c, n=n, stale_frac=stale_frac)
        r = rtheory.plan(eps=eps, c=c, n=n, stale_frac=stale_frac)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        for args in ((t.theta, 0.0, 0.0), (t.theta, 1e-3, 2e-4),
                     (0.5 * t.theta, 0.02, 0.0)):
            assert ttheory.stale_increment(t, *args) == \
                rtheory.stale_increment(r, *args)


def test_plan_refuses_stale_frac_as_reference():
    for bad in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match=r"stale_frac must be in \[0,1\)"):
            ttheory.plan(eps=0.1, stale_frac=bad)
        with pytest.raises(ValueError, match=r"stale_frac must be in \[0,1\)"):
            rtheory.plan(eps=0.1, stale_frac=bad)


# ----------------------------------------------------------------------
# mass scans
# ----------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["er", "sinks", "multigraph"])
def test_propagation_mass_matches_reference(name, transpose, weighted):
    r, t = _graphs(name)
    p = rtheory.plan(eps=0.1, c=0.6, n=r.n)
    rng = np.random.default_rng(len(name))
    seeds = np.sort(rng.choice(r.n, 20, replace=False))
    w = rng.uniform(0.05, 1.0, len(seeds)) if weighted else None
    # block 8 splits the 20 seeds into buckets of 8, 8 and 4 -> 16
    ref = rhp.propagation_mass(r, seeds, p.sqrt_c, p.theta, p.l_max,
                               transpose=transpose, block=8, weights=w)
    got = thp.propagation_mass(t, seeds, p.sqrt_c, p.theta, p.l_max,
                               transpose=transpose, block=8, weights=w,
                               device="cpu")
    for g_, r_ in zip(got, ref):
        assert g_.dtype == np.float64 and g_.shape == (r.n,)
        np.testing.assert_allclose(g_, r_, atol=ATOL, rtol=0)
    assert got[2].max() > 0     # the prune skipped some mass


def test_propagation_mass_runs_every_step():
    """No early exit: a frontier that drops under theta_r still has its
    sub-threshold mass added to ``skipped`` at that step (the reference
    scans all l_max + 1 steps)."""
    _, t = _graphs("powerlaw")
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    seeds = np.array([5])
    # theta_r above every propagated value: only step 0 is kept, and
    # step 1's whole frontier is pruned mass
    colmax, total, skipped = thp.propagation_mass(
        t, seeds, p.sqrt_c, 0.99, p.l_max, device="cpu")
    assert colmax[5] == 1.0 and total.sum() == 1.0
    h1 = thp.exact_hp_vectors(t, seeds, p.sqrt_c, 1)[1]
    assert h1.max() < 0.99
    assert skipped.sum() == pytest.approx(h1.sum(), abs=1e-6)


def test_one_hot_block_buckets_match_reference():
    for k, block in ((1, 256), (16, 256), (17, 256), (200, 256),
                     (256, 256), (300, 256), (5, 7)):
        sub = np.arange(k)
        ref = np.asarray(rhp._one_hot_block(400, sub, block))
        got = thp._one_hot_block(400, sub, block, "cpu").numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------------
# row repair and update_index against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ZOO)
def test_repair_hp_rows_matches_reference(name):
    r, t = _graphs(name)
    ri = rbuild.build_index(r, eps=0.1, exact_d=True)
    ti = _carry(ri)
    delta = rupdate.random_delta(r, n_add=6, n_del=6, seed=4)
    r2, touched, _ = rcsr.apply_edges(r, delta)
    t2 = convert.graph_from_arrays(r2.n, r2.edge_src, r2.edge_dst)
    rng = np.random.default_rng(1)
    rows = np.union1d(touched, rng.choice(r.n, r.n // 2, replace=False))
    targets = np.union1d(touched, rng.choice(r.n, r.n // 3, replace=False))
    rs = rhp.repair_hp_rows(r2, ri.hp, rows, targets, block=16)
    ts = thp.repair_hp_rows(t2, ti.hp, rows, targets, block=16)
    assert ts == rs
    assert ti.hp.width == ri.hp.width
    _assert_tables_match(ti.hp, ri.hp, ri.plan.theta, n=r.n)
    np.testing.assert_array_equal(ti.hp.counts.numpy(), ri.hp.counts)


def test_repair_grows_width_as_reference():
    """A delta that densifies a hub's neighbourhood must re-pad the
    table wider rather than truncate the repaired rows."""
    r, t = _graphs("powerlaw")
    ri = rbuild.build_index(r, eps=0.3, exact_d=True)
    ti = _carry(ri)
    w0 = ri.hp.width
    delta = rcsr.GraphDelta.inserts(np.arange(30, 60), np.zeros(30))
    rrep = rupdate.update_index(ri, r, delta, exact_d=True)
    trep = tupdate.update_index(ti, t, _tdelta(delta), exact_d=True)
    assert rrep.width_grew and trep.width_grew
    assert ti.hp.width == ri.hp.width > w0
    assert int(ti.hp.counts[0]) > w0
    _assert_tables_match(ti.hp, ri.hp, ri.plan.theta, n=r.n)


@pytest.mark.parametrize("name", ZOO)
def test_update_index_exact_d_matches_reference(name):
    """The R, K and D sets, the report, stale, d and the HP table of one
    batch equal the reference's on an index carried across."""
    r, t = _graphs(name)
    ri = rbuild.build_index(r, eps=0.1, exact_d=True, stale_frac=0.2)
    ti = _carry(ri)
    delta = rupdate.random_delta(r, n_add=4, n_del=4, seed=7)
    r2, touched, tv = rcsr.apply_edges(r, delta)
    t2, _, _ = tcsr.apply_edges(t, _tdelta(delta))
    theta = ri.plan.theta
    ref_sets = rupdate.affected_sets(r, r2, touched, tv, ri.plan, theta)
    got_sets = tupdate.affected_sets(t, t2, touched, tv, ti.plan, theta,
                                     device="cpu")
    for g_, r_ in zip(got_sets[:3], ref_sets[:3]):      # R, K, D
        np.testing.assert_array_equal(g_, r_)
    for g_, r_ in zip(got_sets[3:], ref_sets[3:]):      # m_rows, m_d
        assert g_ == pytest.approx(r_, abs=ATOL)
    rrep = rupdate.update_index(ri, r, delta, exact_d=True)
    trep = tupdate.update_index(ti, t, _tdelta(delta), exact_d=True)
    for f in ("rows_repaired", "targets_seeded", "d_updated", "width_grew",
              "needs_rebuild"):
        assert getattr(trep, f) == getattr(rrep, f), f
    np.testing.assert_array_equal(trep.affected, rrep.affected)
    np.testing.assert_array_equal(trep.touched, rrep.touched)
    assert trep.stale == pytest.approx(rrep.stale, rel=1e-4)
    assert trep.secs.keys() == rrep.secs.keys()
    assert ti.epoch == ri.epoch == 1
    np.testing.assert_allclose(ti.d.numpy(), ri.d, atol=1e-6, rtol=0)
    _assert_tables_match(ti.hp, ri.hp, theta, n=r.n)


@pytest.mark.parametrize("name", ["powerlaw", "multigraph"])
def test_full_coverage_repair_equals_fresh_port_build(name):
    """Repair seeded at every target reproduces a from-scratch port
    build on the new graph entry for entry."""
    _, t = _graphs(name)
    ti = tbuild.build_index(t, eps=0.2, exact_d=True, device="cpu")
    g2, touched, _ = tcsr.apply_edges(
        t, tupdate.random_delta(t, n_add=6, n_del=6, seed=2))
    assert len(touched) > 0
    every = np.arange(t.n)
    thp.repair_hp_rows(g2, ti.hp, rows=every, targets=every)
    fresh = tbuild.build_index(g2, eps=0.2, exact_d=True, device="cpu")
    assert torch.equal(ti.hp.counts, fresh.hp.counts)
    for v in range(t.n):
        c = int(ti.hp.counts[v])
        assert torch.equal(ti.hp.keys[v, :c], fresh.hp.keys[v, :c])
        assert torch.equal(ti.hp.vals[v, :c], fresh.hp.vals[v, :c])


@pytest.mark.parametrize("kind", ["insert", "delete", "mixed"])
@pytest.mark.parametrize("name", ["er", "powerlaw"])
def test_update_within_planned_eps(name, kind):
    """update_index on a random edge batch stays within the planned eps
    of a from-scratch build, and of exact SimRank, on the new graph."""
    _, t = _graphs(name)
    eps = 0.2
    idx = tbuild.build_index(t, eps=eps, exact_d=True, stale_frac=0.2,
                             device="cpu")
    n_mut = max(2, t.m // 100)
    full = tupdate.random_delta(t, n_add=n_mut, n_del=n_mut, seed=len(kind))
    z = np.zeros(0, np.int64)
    delta = {"insert": tcsr.GraphDelta(full.add_src, full.add_dst, z, z),
             "delete": tcsr.GraphDelta(z, z, full.del_src, full.del_dst),
             "mixed": full}[kind]
    rep = tbuild.update_index(idx, t, delta, exact_d=True)
    fresh = tbuild.build_index(rep.graph, eps=eps, exact_d=True,
                               stale_frac=0.2, device="cpu")
    rng = np.random.default_rng(len(name))
    us, vs = rng.integers(0, t.n, 200), rng.integers(0, t.n, 200)
    got = idx.query_pairs(us, vs, device="cpu")
    want = fresh.query_pairs(us, vs, device="cpu")
    assert np.abs(got - want).max() <= idx.plan.eps
    r2 = rcsr.from_edges(rep.graph.n, rep.graph.edge_src,
                         rep.graph.edge_dst, dedup=False)
    S = oracle.exact_simrank(r2, 0.6)
    assert np.abs(got - S[us, vs]).max() <= oracle.tolerance(idx.plan)


def test_noop_delta_is_noop():
    _, t = _graphs("er")
    idx = tbuild.build_index(t, eps=0.2, exact_d=True, device="cpu")
    keys = idx.hp.keys.clone()
    rep = tbuild.update_index(idx, t, tcsr.GraphDelta.empty())
    assert rep.noop and rep.graph is t and idx.epoch == 0
    assert torch.equal(idx.hp.keys, keys)


def test_staleness_accumulates_and_triggers():
    _, t = _graphs("er")
    idx = tbuild.build_index(t, eps=0.2, exact_d=True, stale_frac=0.2,
                             device="cpu")
    assert idx.plan.eps_stale == pytest.approx(0.04)
    g, last, fired = t, 0.0, False
    for i in range(4):
        rep = tbuild.update_index(
            idx, g, tupdate.random_delta(g, 2, 2, seed=10 + i),
            exact_d=True)
        g = rep.graph
        assert rep.stale >= last
        last = rep.stale
        fired = fired or rep.needs_rebuild
        assert rep.needs_rebuild == (rep.stale > idx.plan.eps_stale)
    assert idx.epoch == 4 and fired


# ----------------------------------------------------------------------
# subset diagonal (walks)
# ----------------------------------------------------------------------
def test_subset_diagonal_keeps_the_rest_and_matches_full_pass():
    _, t = _graphs("powerlaw")
    p = ttheory.plan(eps=0.3, c=0.6, n=t.n)
    full = tdiagonal.estimate_diagonal(t, p, seed=3, device="cpu")
    sub = tdiagonal.estimate_diagonal(t, p, seed=3, device="cpu",
                                      nodes=np.arange(t.n),
                                      d_init=np.zeros(t.n, np.float32))
    np.testing.assert_array_equal(full, sub)
    d_init = np.random.default_rng(0).random(t.n).astype(np.float32)
    nodes = np.array([1, 4, 9, 30])
    part = tdiagonal.estimate_diagonal(t, p, seed=3, device="cpu",
                                       nodes=nodes, d_init=d_init)
    rest = np.setdiff1d(np.arange(t.n), nodes)
    np.testing.assert_array_equal(part[rest], d_init[rest])
    assert np.abs(part[nodes] - tdiagonal.exact_diagonal(t, 0.6)[nodes]
                  ).max() <= p.eps_d
    with pytest.raises(ValueError, match="d_init"):
        tdiagonal.estimate_diagonal(t, p, nodes=nodes, device="cpu")


@pytest.mark.parametrize("name", ["er", "multigraph"])
def test_update_walk_diagonal_within_eps_d(name):
    """Without exact_d the D rows are re-estimated by walks on the new
    graph (the port's RNG is not JAX's): |d~ - d| <= eps_d there, and
    every other entry keeps its old value."""
    _, t = _graphs(name)
    idx = tbuild.build_index(t, eps=0.2, exact_d=True, stale_frac=0.2,
                             device="cpu")
    d0 = idx.d.clone()
    delta = tupdate.random_delta(t, n_add=3, n_del=3, seed=5)
    g2, touched, tv = tcsr.apply_edges(t, delta)
    _, _, d_nodes, _, _ = tupdate.affected_sets(
        t, g2, touched, tv, idx.plan, idx.plan.theta, device="cpu")
    rep = tbuild.update_index(idx, t, delta, seed=2)
    assert rep.d_updated == len(d_nodes) > 0
    exact = tdiagonal.exact_diagonal(rep.graph, 0.6)
    assert np.abs(idx.d.numpy()[d_nodes] - exact[d_nodes]).max() \
        <= idx.plan.eps_d
    rest = np.setdiff1d(np.arange(t.n), d_nodes)
    assert torch.equal(idx.d[rest], d0[rest])


# ----------------------------------------------------------------------
# engine: hot-swap and invalidation
# ----------------------------------------------------------------------
def _engine(idx, g, cache_size=64):
    return QueryEngine(idx, g, EngineConfig(pair_batch=16, source_batch=4,
                                            cache_size=cache_size),
                       device="cpu")


def _churned():
    _, t = _graphs("powerlaw")
    idx = tbuild.build_index(t, eps=0.1, exact_d=True, device="cpu")
    return t, idx


def test_swap_answers_equal_a_fresh_engine():
    t, idx = _churned()
    eng = _engine(idx, t)
    eng.warmup()
    rep = tbuild.update_index(idx, t, tupdate.random_delta(t, 4, 4, seed=3),
                              exact_d=True)
    eng.swap_index(idx, rep.graph, affected=rep.affected)
    fresh = _engine(idx, rep.graph)
    us = np.arange(t.n)
    np.testing.assert_array_equal(eng.pairs(us, us[::-1]),
                                  fresh.pairs(us, us[::-1]))
    np.testing.assert_array_equal(eng.single_source(us[:9]),
                                  fresh.single_source(us[:9]))
    sv, si = eng.topk(us[:9], 10)
    fv, fi = fresh.topk(us[:9], 10)
    np.testing.assert_array_equal(sv, fv)
    np.testing.assert_array_equal(si, fi)
    st = eng.stats()
    assert st["swaps"] == 1 and st["epoch"] == 1 and st["last_swap_ms"] > 0


def test_swap_cannot_serve_stale_scores():
    """The cache must not serve pre-swap scores for affected nodes."""
    t, idx = _churned()
    eng = _engine(idx, t)
    rep = tbuild.update_index(idx, t, tupdate.random_delta(t, 8, 8, seed=11),
                              exact_d=True)
    hot = [int(x) for x in rep.affected[:4]]
    eng.pair(hot[0], hot[1])
    eng.single_source([hot[2]])
    eng.topk([hot[3]], 5)
    eng.swap_index(idx, rep.graph, affected=rep.affected)
    post = eng.pair(hot[0], hot[1])
    assert post == pytest.approx(idx.query_pair_host(hot[0], hot[1]),
                                 abs=1e-4)
    got = eng.single_source([hot[2]])
    np.testing.assert_allclose(got[0], single_source_horner(
        idx, rep.graph, hot[2]), atol=ATOL)
    fresh = tbuild.build_index(rep.graph, eps=0.1, exact_d=True,
                               device="cpu")
    assert abs(post - fresh.query_pair_host(hot[0], hot[1])) \
        <= idx.plan.eps


def test_unaffected_source_cache_cannot_hide_affected_targets():
    """A cached vector for an unaffected source holds scores at affected
    targets, so a non-empty hot set drops every source/top-k entry."""
    t, idx = _churned()
    eng = _engine(idx, t)
    # one insert and one delete leave most of the 64 nodes unaffected
    rep = tbuild.update_index(idx, t, tupdate.random_delta(t, 1, 1, seed=2),
                              exact_d=True)
    cold = np.setdiff1d(np.arange(idx.n), rep.affected)[:8]
    assert len(cold), "churn affected every node; pick another seed"
    pre = eng.single_source(cold).copy()
    eng.topk(cold, 5)
    eng.swap_index(idx, rep.graph, affected=rep.affected)
    ref = np.stack([single_source_horner(idx, rep.graph, int(u))
                    for u in cold])
    got = eng.single_source(cold)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    aff = np.asarray(rep.affected, np.int64)
    assert np.abs(pre[:, aff] - ref[:, aff]).max() > 1e-5
    sv, _ = eng.topk(cold, 5)
    np.testing.assert_allclose(sv, np.sort(ref, axis=1)[:, ::-1][:, :5],
                               atol=ATOL)


def _meeting_nodes(idx, u, v):
    hp = idx.hp
    ku = hp.keys[u, :int(hp.counts[u])].numpy()
    kv = hp.keys[v, :int(hp.counts[v])].numpy()
    return set((np.intersect1d(ku, kv).astype(np.int64) % idx.n).tolist())


def test_unaffected_pair_dropped_when_meeting_node_hot():
    t, idx = _churned()
    eng = _engine(idx, t)
    rep = tbuild.update_index(idx, t, tupdate.random_delta(t, 1, 1, seed=2),
                              exact_d=True)
    aff = set(int(x) for x in rep.affected)
    cold = [u for u in range(idx.n) if u not in aff]
    found = next(((u, v) for u in cold for v in cold
                  if u < v and _meeting_nodes(idx, u, v) & aff), None)
    assert found, "no cold pair meets an affected node; pick another seed"
    u, v = found
    far = next(((a, b) for a in cold for b in cold
                if a < b and not _meeting_nodes(idx, a, b) & aff), None)
    eng.pair(u, v)
    if far:
        eng.pair(*far)
    eng.swap_index(idx, rep.graph, affected=rep.affected)
    assert ("pair", u, v) not in eng._cache._d
    if far:         # a cold pair meeting no hot node survives
        assert ("pair", *far) in eng._cache._d
    assert eng.pair(u, v) == pytest.approx(idx.query_pair_host(u, v),
                                           abs=1e-4)


def test_swap_that_fits_keeps_the_shape_set():
    t, idx = _churned()
    eng = _engine(idx, t)
    eng.warmup()
    before = eng.stats()["unique_shapes"]
    g = t
    rng = np.random.default_rng(3)
    for i in range(3):
        rep = tbuild.update_index(idx, g, tupdate.random_delta(
            g, 4, 4, seed=20 + i), exact_d=True)
        g = rep.graph
        out = eng.swap_index(idx, g, affected=rep.affected)
        assert out["recompiles"] == 0 and out["epoch"] == i + 1
        us = rng.integers(0, idx.n, 5)
        eng.pairs(us, us[::-1])
        eng.single_source(us)
        eng.topk(us, 7)
    st = eng.stats()
    assert st["unique_shapes"] == before
    assert st["swap_recompiles"] == 0 and st["swaps"] == 3


def test_width_overflow_is_counted_and_correct():
    t, idx = _churned()
    eng = _engine(idx, t)
    eng.warmup()
    before = eng.stats()["unique_shapes"]
    wide = tbuild.build_index(t, eps=0.1, exact_d=True, device="cpu")
    grow = eng._width_cap + 7
    keys = torch.full((wide.n, grow), thp.INT32_PAD_KEY, dtype=torch.int32)
    vals = torch.zeros((wide.n, grow))
    keys[:, :wide.hp.width] = wide.hp.keys
    vals[:, :wide.hp.width] = wide.hp.vals
    wide.hp.keys, wide.hp.vals, wide.hp.width = keys, vals, grow
    out = eng.swap_index(wide, t)
    assert out["recompiles"] == 1 and eng.stats()["swap_recompiles"] == 1
    assert eng._width_cap >= grow
    us = np.arange(10)
    got = eng.pairs(us, (us * 7) % wide.n)
    np.testing.assert_allclose(
        got, [wide.query_pair_host(int(u), int(u) * 7 % wide.n)
              for u in us], atol=1e-4)
    assert eng.stats()["unique_shapes"] != before   # the bucket grew


def test_swap_refusals():
    t, idx = _churned()
    eng = _engine(idx, t)
    g5 = tcsr.from_edges(5, [0, 1], [1, 2])
    small = tbuild.build_index(g5, eps=0.1, exact_d=True, device="cpu")
    with pytest.raises(ValueError, match="fixed node set"):
        eng.swap_index(small, g5)
    unc = tbuild.build_index(t, eps=0.1, exact_d=True, device="cpu")
    unc.uncertified_d = True
    with pytest.raises(ValueError, match="uncertified"):
        eng.swap_index(unc, t)
    other = tbuild.build_index(t, eps=0.05, exact_d=True, device="cpu")
    assert eng.swap_index(other, t)["recompiles"] >= 1   # l_max changed


def test_engine_does_not_alias_the_index():
    """The engine keeps copies: an in-place change of the index's d (as
    update_index makes) leaves answers unchanged until swap_index."""
    t, idx = _churned()
    eng = _engine(idx, t, cache_size=0)
    us = np.arange(idx.n)
    pairs0 = eng.pairs(us, us[::-1])
    src0 = eng.single_source(us[:4])
    idx.d.mul_(0.5)
    idx.hp.vals.mul_(0.5)
    np.testing.assert_array_equal(eng.pairs(us, us[::-1]), pairs0)
    np.testing.assert_array_equal(eng.single_source(us[:4]), src0)
    eng.swap_index(idx, t)
    assert np.abs(eng.pairs(us, us[::-1]) - pairs0).max() > 1e-3


def test_serve_cli_mutate_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--n", "200", "--queries", "8", "--mode", "source", "--mutate",
         "2"], env=env, capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[mutate 1] touched=" in out.stdout
    assert "(fixed-shape swap OK)" in out.stdout


def test_public_functions_default_to_the_card(monkeypatch):
    """build_hp_table, estimate_diagonal and propagation_mass run on
    cuda unless asked for the CPU: without a card they raise instead of
    taking the CPU on their own."""
    _, t = _graphs("er")
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max),
            lambda: tdiagonal.estimate_diagonal(t, p),
            lambda: thp.propagation_mass(t, [0], p.sqrt_c, p.theta,
                                         p.l_max)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
