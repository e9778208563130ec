"""The port's test oracles and kernel-level entry points held against
the reference: the Lemma-3 walk estimator and whole walk trajectories,
``SlingIndex.device_arrays``, ``query_pairs_kernel`` / ``spmm`` (the
plain versions on the CPU) against the reference's Pallas entries in
interpret mode and their ``_reference`` twins, and the ``sling-serve``
config with its two steps."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from repro.configs import base as rconfigs
from repro.core import build as rbuild
from repro.graph import csr as rcsr
from repro.graph import generators as rgen
from repro.kernels.hp_join import ops as rhops
from repro.kernels.spmv_ell import ops as rspmm
from repro.train import steps as rsteps
from repro_torch import convert
from repro_torch.configs import base as tconfigs
from repro_torch.core import build as tbuild
from repro_torch.core import device_state
from repro_torch.core import shard_query as tsq
from repro_torch.core import walks as twalks
from repro_torch.core.quantize import quantize_index
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.kernels.hp_join import ops as thops
from repro_torch.kernels.spmv_ell import ops as tspmm
from repro_torch.launch import mesh as tmesh
from repro_torch.train import steps as tsteps
from torch_cases import table_case

ATOL = oracle.BACKEND_ATOL
SQRT_C = math.sqrt(0.6)


def _ref_graph():
    """tests/conftest.py's small_graph, built with the port."""
    return tgen.barabasi_albert(150, 3, seed=1, directed=False)


# ----------------------------------------------------------------------
# walk oracles
# ----------------------------------------------------------------------
def test_meet_probability_is_simrank(ground_truth):
    """tests/test_walks.py's pairs and bound, on the port's walks."""
    g = _ref_graph()
    for u, v in [(3, 11), (0, 1), (20, 40)]:
        est = twalks.estimate_simrank_by_walks(g, u, v, c=0.6,
                                               n_walks=20000, seed=0,
                                               device="cpu")
        assert abs(est - ground_truth[u, v]) < 0.02, (u, v, est)


def test_equal_pair_meets_trivially():
    g = _ref_graph()
    assert twalks.estimate_simrank_by_walks(g, 4, 4, c=0.6, n_walks=500,
                                            seed=0, device="cpu") == 1.0


def test_paired_meet_chunked_chunks_and_equal_starts():
    g = _ref_graph()
    dg = twalks.DeviceGraph.from_graph(g, device="cpu")
    rng = np.random.default_rng(1)
    sa = rng.integers(0, g.n, 700)
    sb = rng.integers(0, g.n, 700)
    sb[:50] = sa[:50]
    for chunk in (64, 700, 1 << 12):
        gen = torch.Generator().manual_seed(2)
        met = twalks.paired_meet_chunked(dg, sa, sb, gen, SQRT_C, 10,
                                         chunk=chunk)
        assert met.shape == (700,) and met.dtype == bool
        assert met[sa == sb].all() and not met.all()
    one = twalks.paired_meet_chunked(dg, sa, sb,
                                     torch.Generator().manual_seed(2),
                                     SQRT_C, 10)
    again = twalks.paired_meet(dg.in_ptr, dg.in_idx, dg.in_deg,
                               torch.as_tensor(sa), torch.as_tensor(sb),
                               torch.Generator().manual_seed(2), SQRT_C, 10)
    np.testing.assert_array_equal(one, again.numpy())


@pytest.mark.parametrize("name", ("powerlaw", "dag", "sinks", "multigraph"))
def test_walk_positions_stop_monotone_through_in_neighbors(name):
    g = {"powerlaw": _ref_graph(), "dag": tgen.dag(40, 110, seed=5),
         "sinks": tgen.with_sinks(40, 120, n_sinks=5, seed=7),
         "multigraph": tgen.multigraph(32, 90, seed=9)}[name]
    dg = twalks.DeviceGraph.from_graph(g, device="cpu")
    starts = np.arange(64) % g.n
    traj = twalks.walk_positions(dg.in_ptr, dg.in_idx, dg.in_deg, starts,
                                 torch.Generator().manual_seed(0), 0.7746,
                                 20).numpy()
    assert traj.shape == (64, 21) and traj.dtype == np.int32
    np.testing.assert_array_equal(traj[:, 0], starts)
    stopped = traj == -1
    # once a walk stops (-1) it stays stopped
    assert np.all(stopped[:, 1:] >= stopped[:, :-1])
    for row in traj:
        live = row[row >= 0]
        for a, b in zip(live[:-1], live[1:]):
            assert b in g.in_neighbors(int(a))
    moved = (~stopped[:, 1]).mean()
    assert 0.3 < moved < 1.0        # sqrt(c) = 0.77 continues, sinks stop


# ----------------------------------------------------------------------
# device_arrays and the kernel-level entry points
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def carried():
    rg = rgen.barabasi_albert(120, 3, seed=2, directed=False)
    ri = rbuild.build_index(rg, eps=0.15, exact_d=True)
    tg = convert.graph_from_arrays(rg.n, rg.edge_src, rg.edge_dst)
    ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                   ri.hp.keys, ri.vals_f32(), ri.hp.counts,
                                   device="cpu")
    return rg, ri, tg, ti


def test_device_arrays_are_the_uploaded_index(carried):
    device_state.cache_clear()
    _, _, _, ti = carried
    keys, vals, d = ti.device_arrays("cpu")
    assert keys is ti.hp.keys and d is ti.d          # no copy on its device
    assert torch.equal(vals, ti.vals_f32())
    again = ti.device_arrays("cpu")
    assert all(a is b for a, b in zip(again, (keys, vals, d)))
    tg = tgen.barabasi_albert(60, 3, seed=0, directed=False)
    idx = tbuild.build_index(tg, eps=0.2, exact_d=True, quant_frac=0.2,
                             device="cpu")
    q = quantize_index(idx, "int16")
    qk, qv, qd = q.device_arrays("cpu")
    assert qv.dtype == torch.float32 and q.hp.vals.dtype == torch.int16
    assert torch.equal(qv, q.vals_f32()) and torch.equal(qk, q.hp.keys)
    assert torch.equal(qd, q.d)


@pytest.mark.parametrize("seed", [0, 1])
def test_query_pairs_kernel_matches_reference(carried, seed):
    rg, ri, _, ti = carried
    rng = np.random.default_rng(seed)
    us = rng.integers(0, rg.n, 24).astype(np.int32)
    vs = rng.integers(0, rg.n, 24).astype(np.int32)
    vs[:3] = us[:3]
    got = thops.query_pairs_kernel(ti, us, vs, device="cpu")
    plain = thops.query_pairs_reference(ti, us, vs, device="cpu")
    assert got.shape == (24,) and got.dtype == np.float32
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got, rhops.query_pairs_kernel(ri, us, vs, bq=8), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        plain, rhops.query_pairs_reference(ri, us, vs), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ti.query_pairs(us, vs, device="cpu"),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,deg,f", [(40, 2, 8), (100, 5, 24), (64, 3, 33)])
def test_spmm_entry_matches_reference(n, deg, f):
    rg = rgen.barabasi_albert(n, deg, seed=n + deg, directed=False)
    tg = tgen.barabasi_albert(n, deg, seed=n + deg, directed=False)
    w = rcsr.normalized_pull_weights(rg, 0.7746)
    np.testing.assert_array_equal(tcsr.normalized_pull_weights(tg, 0.7746),
                                  w)
    x = np.random.default_rng(0).normal(size=(rg.n, f)).astype(np.float32)
    got = tspmm.spmm(x, tg, w, device="cpu")
    plain = tspmm.spmm_reference(x, tg, w, device="cpu")
    assert got.shape == (n, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(rspmm.spmm(x, rg, w, bn=8, eb=16)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(plain.numpy(),
                               np.asarray(rspmm.spmm_reference(x, rg, w)),
                               atol=ATOL, rtol=ATOL)


def test_spmm_entry_empty_rows():
    """tests/test_kernels.py's empty-row case, on the port."""
    g = tcsr.from_edges(6, np.array([0, 1]), np.array([2, 2]))
    w = np.ones(g.m, np.float32)
    out = tspmm.spmm(np.eye(6, 4, dtype=np.float32), g, w,
                     device="cpu").numpy()
    assert out[2, 0] == 1.0 and out[2, 1] == 1.0
    assert np.all(out[[0, 1, 3, 4, 5]] == 0)


# ----------------------------------------------------------------------
# the sling-serve config and its steps
# ----------------------------------------------------------------------
def test_sling_serve_is_registered_as_in_reference():
    t, r = tconfigs.get("sling-serve"), rconfigs.get("sling-serve")
    assert "sling-serve" in tconfigs.all_archs()
    assert (t.family, t.shapes, t.notes) == (r.family, r.shapes, r.notes)
    for part in ("full", "smoke"):
        assert dataclasses.asdict(getattr(t, part)()) == \
            dataclasses.asdict(getattr(r, part)())
    cfg = t.full()
    assert (cfg.n, cfg.batch, cfg.l_max) == (1_000_000, 1024, 12)
    assert tsteps._sling_tau(cfg) == rsteps._sling_tau(cfg)


def _serve_case(cfg, seed=0):
    """smoke()-shaped arrays: an Erdos-Renyi graph of cfg.n nodes and
    cfg.m edges, a packed table (n, hp_width) of sorted keys over levels
    0 .. l_max with PAD tails, d, and cfg.batch source ids."""
    rg = rgen.erdos_renyi(cfg.n, cfg.m, seed=seed)
    tg = tgen.erdos_renyi(cfg.n, cfg.m, seed=seed)
    rng = np.random.default_rng(seed)
    case = table_case(rng, n=cfg.n, rows=cfg.n, W=cfg.hp_width,
                      l_max=cfg.l_max, m=1)
    us = rng.choice(cfg.n, cfg.batch, replace=False).astype(np.int32)
    return rg, tg, case, us


@pytest.mark.parametrize("seed", [0, 1])
def test_sling_serve_step_matches_reference(seed):
    cfg = tconfigs.get("sling-serve").smoke()
    rg, tg, case, us = _serve_case(cfg, seed)
    w = rcsr.normalized_pull_weights(rg, cfg.c ** 0.5)
    want = np.asarray(rsteps.sling_serve_step(cfg)(
        {"keys": jnp.asarray(case["ku"]), "vals": jnp.asarray(case["xu"]),
         "d": jnp.asarray(case["d"])},
        {"edge_src": jnp.asarray(rg.edge_src),
         "edge_dst": jnp.asarray(rg.edge_dst), "w": jnp.asarray(w)},
        {"us": jnp.asarray(us)}))
    index = {k: torch.as_tensor(case[a]) for k, a in
             (("keys", "ku"), ("vals", "xu"), ("d", "d"))}
    from repro_torch.kernels.spmv_ell import SpmmLayout
    graph = {"layout": SpmmLayout.pull(tg, cfg.c ** 0.5, "cpu")}
    got = tsteps.sling_serve_step(cfg)(index, graph, {"us": us})
    assert got.shape == (cfg.batch, cfg.n) and got.dtype == torch.float32
    assert float(got.max()) > 0.01
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sling_serve_step_sharded_equals_unsharded(shape):
    cfg = tconfigs.get("sling-serve").smoke()
    _, tg, case, us = _serve_case(cfg, 3)
    index = {k: torch.as_tensor(case[a]) for k, a in
             (("keys", "ku"), ("vals", "xu"), ("d", "d"))}
    from repro_torch.kernels.spmv_ell import SpmmLayout
    one = tsteps.sling_serve_step(cfg)(
        index, {"layout": SpmmLayout.pull(tg, cfg.c ** 0.5, "cpu")},
        {"us": us})
    mesh = tmesh.make_debug_mesh(shape, ("data", "model"),
                                 devices=["cpu"] * 2)
    S = mesh.shape["model"]
    n_l = cfg.n // S
    bs, bd, bw = tsq.partition_edges(tg, cfg.c ** 0.5, S, n_l,
                                     tsq.required_edge_cap(tg, S, n_l))
    graph = {"blk_src": bs, "blk_dstl": bd, "blk_w": bw}
    step = tsteps.sling_serve_step_sharded(cfg, mesh)
    got = step(index, graph, {"us": us})
    assert got.shape == (cfg.batch, cfg.n)
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    from repro_torch.core.single_source import pod_slabs
    graph["slabs"] = pod_slabs(index["d"], bs, bd, bw, cfg.n, mesh)
    np.testing.assert_array_equal(step(index, graph, {"us": us}).numpy(),
                                  one.numpy())
