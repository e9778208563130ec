"""The port's node-sharded SLING (repro_torch.core.shard_query, the
sharded build and walks, the mesh-aware engine, join and CLI) held
against the reference on the oracle zoo, with CPU shards in one
process: a mesh may repeat a device, so ``["cpu"] * S`` is the port's
counterpart of the reference's forced host devices.

The same seeded inputs go through both packages. The reference's own
S > 1 answers need forced host devices, which must be set before JAX
starts, so one subprocess computes them (``ref_4way``); everything else
runs here. The CUDA kernel of the slab push (``horner_push_slabs``) is
held against its plain version in tests/test_torch_cuda.py (on the card
only).
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.core import hp_index as rhp
from repro.core import shard_query as rsq
from repro.core import theory as rtheory
from repro.core import walks as rwalks
from repro.core.single_source import single_source_device as r_source
from repro.core.single_source import single_source_horner as r_horner
from repro.core.topk import topk_device as r_topk
from repro.graph import csr as rcsr
from repro.graph import generators as rgen
from repro.join import JoinConfig as RJoinConfig
from repro.join import run_join as rrun_join
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core import diagonal as tdiagonal
from repro_torch.core import hp_index as thp
from repro_torch.core import shard_query as tsq
from repro_torch.core import update as tupdate
from repro_torch.core import walks as twalks
from repro_torch.core.single_source import (batched_single_source_sharded,
                                            pod_slabs,
                                            prune_tau, single_source_batch,
                                            single_source_device,
                                            slab_horner_push)
from repro_torch.join import JoinConfig, run_join
from repro_torch.kernels import horner_push as hpk
from repro_torch.kernels.horner_push import (MAX_SEGMENTS, MAX_SLABS, Slab,
                                             frontier_view,
                                             horner_push_slabs,
                                             horner_push_slabs_plain,
                                             horner_slab_step_plain,
                                             rows_by_owner, top_level,
                                             workspace_numel)
from repro_torch.kernels.spmv_ell import SpmmLayout
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.serve import EngineConfig, QueryEngine

ATOL = oracle.BACKEND_ATOL
ZOO = sorted(oracle.cases())
ROOT = Path(__file__).resolve().parent.parent
US = [0, 3, 17, 31]          # query ids present in every zoo graph
_cells: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny ops: one intra-op thread keeps them from contending with the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(S: int):
    return tsq.serving_mesh(S, devices=["cpu"] * S)


def _cell(name: str):
    """The reference's exact-d index on a zoo graph (eps 0.1), and the
    same index and graph carried to the port."""
    if name not in _cells:
        g = oracle.cases()[name]
        ri = rbuild.build_index(g, eps=0.1, exact_d=True, seed=0)
        tg = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
        ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                       ri.hp.keys, ri.vals_f32(),
                                       ri.hp.counts, device="cpu")
        _cells[name] = (g, ri, tg, ti)
    return _cells[name]


def _check_topk(tv, ti_, rv, ri_, dense):
    """Scores within ATOL; ids equal wherever the reference's scores
    are not near-tied, and every returned id's exact score matches."""
    np.testing.assert_allclose(tv, rv, atol=ATOL, rtol=0)
    for b in range(len(tv)):
        gap = np.abs(np.diff(rv[b]))
        clear = np.concatenate([[True], gap > ATOL]) & \
            np.concatenate([gap > ATOL, [True]])
        np.testing.assert_array_equal(ti_[b][clear], ri_[b][clear])
        np.testing.assert_allclose(dense[b][ti_[b]], tv[b], atol=ATOL,
                                   rtol=0)


# ----------------------------------------------------------------------
# the mesh and the sharding table
# ----------------------------------------------------------------------
def test_debug_mesh_shape_and_devices():
    m = tmesh.make_debug_mesh((2, 3), ("data", "model"),
                              devices=["cpu"] * 6)
    assert m.shape == {"data": 2, "model": 3}
    assert m.devices.shape == (2, 3)
    assert m.axis_devices("model", data=1) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_debug_mesh((2, 3), ("data", "model"), devices=["cpu"])
    with pytest.raises(ValueError, match="no axis"):
        m.axis_devices("pod")


def test_serving_mesh_needs_the_cards(monkeypatch):
    """Without ``devices`` the mesh takes the first S CUDA devices and
    refuses fewer; explicit devices may repeat one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        tsq.serving_mesh(4)
    assert tsq.serving_mesh(2).axis_devices("data") == (
        torch.device("cuda", 0), torch.device("cuda", 1))
    four = tsq.serving_mesh(4, devices=["cuda:0"] * 4)
    assert four.axis_devices("data") == (torch.device("cuda", 0),) * 4


def test_sharded_index_on_the_card_runs_the_kernel():
    """No quiet fallback: on ``cuda`` a ShardedIndex resolves to the
    kernel (whose wrapper launches or raises), and the reference's
    backend names are refused, not mapped to the plain push."""
    cuda = types.SimpleNamespace(devices=(torch.device("cuda", 0),) * 2)
    assert tsq._resolve_si_backend(cuda, None) == "kernel"
    assert tsq._resolve_si_backend(cuda, "auto") == "kernel"
    g, _, tg, ti = _cell("powerlaw")
    si = tsq.shard_index(ti, tg, _mesh(2))
    assert tsq._resolve_si_backend(si, None) == "plain"
    for name in ("lax", "pallas"):
        with pytest.raises(ValueError, match="not in"):
            tsq.sharded_single_source(si, US, backend=name)


@pytest.mark.parametrize("n,S", [(150, 4), (8, 1), (7, 7), (64, 3),
                                 (3, 4)])
def test_shard_layout_matches_reference(n, S):
    if S > n:
        for mod in (rhp, thp):
            with pytest.raises(ValueError):
                mod.shard_layout(n, S)
    else:
        assert thp.shard_layout(n, S) == rhp.shard_layout(n, S)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("name", ZOO)
def test_edge_partition_keeps_the_edges(name, S):
    """``partition_edges`` equals the reference's arrays, and the slab
    layouts of ``shard_index`` hold the graph's edge multiset: every
    edge once, in the shard of its destination, at its pull weight."""
    g, ri, tg, ti = _cell(name)
    n_pad, n_loc = thp.shard_layout(g.n, S)
    cap = tsq.required_edge_cap(tg, S, n_loc)
    assert cap == rsq.required_edge_cap(g, S, n_loc)
    for a, b in zip(tsq.partition_edges(tg, ri.plan.sqrt_c, S, n_loc, cap),
                    rsq.partition_edges(g, ri.plan.sqrt_c, S, n_loc, cap)):
        np.testing.assert_array_equal(a, b)
    si = tsq.shard_index(ti, tg, _mesh(S))
    got = []
    for sl in si.slabs:
        lay = sl.layout
        dst = np.repeat(np.arange(lay.n), np.diff(lay.in_ptr.numpy()))
        got += list(zip(lay.in_idx.tolist(), (dst + sl.start).tolist(),
                        lay.w.tolist()))
    w = rcsr.normalized_pull_weights(g, ri.plan.sqrt_c)
    want = list(zip(g.edge_src.tolist(), g.edge_dst.tolist(),
                    w.astype(np.float32).tolist()))
    assert sorted(got) == sorted(want)
    assert si.edge_cap >= cap and si.n_pad == n_pad


# ----------------------------------------------------------------------
# the fan-out against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("name", ZOO)
def test_sharded_queries_match_reference(name, S):
    """Single-source and top-k over S CPU shards against the reference's
    one-device paths (and, on one graph, its serving_mesh(1) fan-out,
    whose compiles cost seconds a graph)."""
    g, ri, tg, ti = _cell(name)
    si = tsq.shard_index(ti, tg, _mesh(S))
    us = np.asarray(US, np.int32)
    ref = r_source(ri, g, us)
    got = tsq.sharded_single_source(si, us)
    assert got.shape == (len(us), g.n)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got, single_source_device(
        ti, tg, us, device="cpu"))
    tv, ti_ = tsq.sharded_topk(si, us, 10)
    rv, ri_ = r_topk(ri, g, us, 10)
    _check_topk(tv, ti_, rv, ri_, ref)
    if S == 1 and name == "powerlaw":
        rsi = rsq.shard_index(ri, g, rsq.serving_mesh(1))
        np.testing.assert_allclose(got, rsq.sharded_single_source(rsi, us),
                                   atol=ATOL, rtol=0)
        fv, fi = rsq.sharded_topk(rsi, us, 10)
        _check_topk(tv, ti_, fv, fi, ref)


def test_topk_ties_go_to_the_smaller_id_across_shards():
    """A star's leaves tie exactly: the merged candidates keep ascending
    ids across shard boundaries, as one device does."""
    from repro_torch.graph import generators
    star = generators.barabasi_albert(40, 1, seed=0, directed=False)
    idx = tbuild.build_index(star, eps=0.1, exact_d=True, device="cpu")
    us = np.arange(6, dtype=np.int32)
    want = tsq.sharded_topk(tsq.shard_index(idx, star, _mesh(1)), us, 12)
    for S in (3, 4):
        got = tsq.sharded_topk(tsq.shard_index(idx, star, _mesh(S)), us, 12)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    v, i = want
    for b in range(len(us)):
        tie = np.flatnonzero(np.diff(v[b]) == 0)
        assert (i[b][tie] < i[b][tie + 1]).all()


@pytest.mark.parametrize("S", [3, 4])
def test_topk_merge_across_devices_equals_one_sort(S):
    """The merge that shards on several devices take -- each slab's
    stable candidates, pad rows masked, a second stable sort -- equals
    the one stable top-k that shards on one device take, ids and scores,
    on a star whose leaves tie exactly."""
    from repro_torch.core.topk import stable_topk
    from repro_torch.graph import generators
    star = generators.barabasi_albert(40, 1, seed=0, directed=False)
    idx = tbuild.build_index(star, eps=0.1, exact_d=True, device="cpu")
    si = tsq.shard_index(idx, star, _mesh(S))
    outs = tsq.sharded_scores(si, np.arange(6))
    for k in (1, 5, 12, 40):
        v, i = tsq._merge_topk(outs, si.n, si.n_loc, k, "cpu")
        wv, wi = stable_topk(torch.cat(outs)[:si.n].t(), k)
        assert torch.equal(v, wv) and torch.equal(i, wi)


def test_single_source_batch_with_a_mesh_matches_reference():
    g, ri, tg, ti = _cell("er")
    got = single_source_batch(ti, tg, US, mesh=_mesh(3))
    np.testing.assert_allclose(got, r_source(ri, g, np.asarray(US)),
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        got, single_source_batch(ti, tg, US, device="cpu"))


def test_nbytes_per_shard_falls_with_the_shard_count():
    g, ri, tg, ti = _cell("powerlaw")
    b = [tsq.shard_index(ti, tg, _mesh(S)).nbytes_per_shard()
         for S in (1, 2, 4)]
    assert b[0] > b[1] > b[2] > 0


# ----------------------------------------------------------------------
# the slab step and the pod path
# ----------------------------------------------------------------------
def _ref_slab_push(ku, xu, d, blocks, tau, n, l_max, n_loc):
    """A NumPy transcription of the reference's ``horner_push`` with
    ``slab_start`` / ``d_offset`` / ``gather`` (src/repro/core/
    single_source.py), run for every shard in lockstep: the shard's
    seed over its slab, then per level the pruned slabs all-gathered
    and segment-summed onto the shard's rows. float32 throughout."""
    S = len(blocks)
    B = ku.shape[0]
    ls = np.where(ku == thp.INT32_PAD_KEY, -1, ku // n)
    ks = np.clip(ku % n, 0, n - 1)

    def seed(s, lv):
        k_loc = ks - s * n_loc
        mine = (ls == lv) & (k_loc >= 0) & (k_loc < n_loc)
        contrib = xu * d[s][np.clip(k_loc, 0, n_loc - 1)]
        z = np.zeros((B, n_loc), np.float32)
        b_idx, j_idx = np.nonzero(mine)
        np.add.at(z, (b_idx, k_loc[b_idx, j_idx]), contrib[b_idx, j_idx])
        return z

    acc = [seed(s, l_max) for s in range(S)]
    for lv in range(l_max - 1, -1, -1):
        xg = np.concatenate([np.where(a > tau, a, np.float32(0))
                             for a in acc], axis=1)
        nxt = []
        for s, (src, dstl, w) in enumerate(blocks):
            z = np.zeros((B, n_loc), np.float32)
            np.add.at(z, (slice(None), dstl), xg[:, src] * w[None, :])
            nxt.append(z + seed(s, lv))
        acc = nxt
    return np.concatenate(acc, axis=1)


def _slab_case(name, S):
    """The reference's rows of US and its dst-partitioned edges on a zoo
    graph cut into S slabs (the last padded past n), as the port's
    slabs on the CPU (d sliced with them, d_offset = the slab's
    start)."""
    g, ri, tg, ti = _cell(name)
    n_pad, n_loc = thp.shard_layout(g.n, S)
    ku = ri.hp.keys[US]
    xu = ri.vals_f32()[US]
    dpad = np.zeros(n_pad, np.float32)
    dpad[:g.n] = ri.d
    d = [dpad[s * n_loc:(s + 1) * n_loc] for s in range(S)]
    cap = rsq.required_edge_cap(g, S, n_loc)
    blocks = list(zip(*rsq.partition_edges(g, ri.plan.sqrt_c, S, n_loc,
                                           cap)))
    slabs = [Slab(layout=SpmmLayout.from_edges(s_, d_, w_, n_loc, "cpu"),
                  d=torch.as_tensor(d[s]), start=s * n_loc,
                  d_offset=s * n_loc)
             for s, (s_, d_, w_) in enumerate(blocks)]
    tau = np.float32(prune_tau(ri.plan))
    return g, ri, ku, xu, d, blocks, slabs, tau, n_loc


def _per_level_push(ku, xu, slabs, tau, n, l_max, bf16=False):
    """The PR-21 route on the plain step: every level on every slab from
    l_max, the slabs all-gathered (concatenated) between levels, as
    bfloat16 under ``bf16``."""
    keys, vals = torch.as_tensor(ku), torch.as_tensor(xu)
    x = None
    for level in range(l_max, -1, -1):
        outs = [horner_slab_step_plain(
            x, sl.layout, keys, vals, sl.d, level, float(tau), n=n,
            slab_start=sl.start, d_offset=sl.d_offset) for sl in slabs]
        x = torch.cat(outs)
        if bf16 and level > 0:
            x = x.to(torch.bfloat16).float()
    return x


def _slabs_plain(ku, xu, slabs, tau, n, l_max, **kw):
    """``horner_push_slabs_plain`` over every level, the rows as one
    segment: the (rows, B) node-major result."""
    B = len(ku)
    n_rows = sum(sl.layout.n for sl in slabs)
    full = torch.empty((n_rows, B))
    horner_push_slabs_plain(
        [(torch.as_tensor(ku), torch.as_tensor(xu), 0)], torch.arange(B),
        slabs, [full[sl.start:sl.start + sl.layout.n] for sl in slabs],
        float(tau), n=n, l_max=l_max, **kw)
    return full


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("name", ["powerlaw", "multigraph", "sinks"])
def test_slab_step_matches_the_reference_slab_push(name, S):
    """``horner_push_slabs_plain`` -- the plain version of the slab
    kernel, every level over every slab into the shared frontier --
    against the per-level route on the plain step (the slabs gathered
    between levels) and against a NumPy transcription of the
    reference's slab push on the same rows and dst-partitioned edges."""
    g, ri, ku, xu, d, blocks, slabs, tau, n_loc = _slab_case(name, S)
    l_max = ri.plan.l_max
    want = _ref_slab_push(ku, xu, d, blocks, tau, g.n, l_max, n_loc)
    got = _slabs_plain(ku, xu, slabs, tau, g.n, l_max)
    per_level = _per_level_push(ku, xu, slabs, tau, g.n, l_max)
    np.testing.assert_allclose(got.numpy(), per_level.numpy(), atol=ATOL,
                               rtol=0)
    got = got.t().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:, :g.n], r_source(ri, g, np.asarray(US)),
                               atol=ATOL, rtol=0)


def test_slab_rows_find_the_top_level():
    """The push starts at the highest level that holds a seed: levels
    above it are exactly zero, so launching a range from l_max gives the
    bits of one from the top; and the levels launched one at a time
    (ranges of one sharing the frontier) give the bits of one call over
    all of them."""
    g, ri, ku, xu, d, blocks, slabs, tau, n_loc = _slab_case("dag", 2)
    l_max = ri.plan.l_max
    live = ku[ku != thp.INT32_PAD_KEY]
    top = top_level(torch.as_tensor(ku), g.n, l_max)
    assert top == int((live // g.n).max())
    assert top_level(torch.full((3, 4), thp.INT32_PAD_KEY), g.n, l_max) == -1
    whole = _slabs_plain(ku, xu, slabs, tau, g.n, l_max)
    B, n_rows = len(US), 2 * n_loc
    ws = torch.full((workspace_numel(n_rows, B, l_max),), float("nan"))
    outs = [torch.empty((n_loc, B)) for _ in slabs]
    rows = [(torch.as_tensor(ku), torch.as_tensor(xu), 0)]
    for level in range(l_max, -1, -1):
        horner_push_slabs_plain(rows, torch.arange(B), slabs, outs,
                                float(tau), n=g.n, l_max=l_max, hi=level,
                                lo=level, n_rows=n_rows, workspace=ws)
        if level > top:    # nothing ran: the frontier is untouched
            assert torch.isnan(frontier_view(ws, n_rows, B)).all()
    assert torch.equal(torch.cat(outs), whole)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_row_source_by_owner_equals_the_psum_fetch(S):
    """The kernel's row source -- each id's row read from the shard that
    owns it -- gives the psum row fetch's rows bit for bit."""
    g, ri, tg, ti = _cell("powerlaw")
    si = tsq.shard_index(ti, tg, _mesh(S))
    us = torch.as_tensor(np.r_[US, g.n - 1, 5, 5], dtype=torch.int64)
    rows = [(k, v, s * si.n_loc) for s, (k, v) in enumerate(zip(si.keys,
                                                              si.vals))]
    ku, xu = rows_by_owner(rows, us)
    want_k, want_x = tsq._query_rows(si, us)
    assert torch.equal(ku, want_k)
    assert torch.equal(xu.view(torch.int32), want_x.view(torch.int32))
    # an id no segment holds is an empty row
    ku, _ = rows_by_owner(rows[:1], us)
    assert (ku[us >= si.n_loc] == thp.INT32_PAD_KEY).all()


@pytest.mark.parametrize("name", ["powerlaw", "sinks"])
def test_bf16_frontier_matches_the_bf16_gather(name):
    """``bf16_frontier``: every frontier value rounded through bfloat16
    where it is written gives the bits of the per-level route whose
    gather sent bfloat16; the result of level 0 stays float32."""
    g, ri, ku, xu, d, blocks, slabs, tau, n_loc = _slab_case(name, 3)
    l_max = ri.plan.l_max
    got = _slabs_plain(ku, xu, slabs, tau, g.n, l_max, bf16_frontier=True)
    want = _per_level_push(ku, xu, slabs, tau, g.n, l_max, bf16=True)
    assert torch.equal(got, want)
    exact = _slabs_plain(ku, xu, slabs, tau, g.n, l_max)
    assert not torch.equal(got, exact)
    assert torch.all((got - exact).abs() <= 0.01 * exact + 1e-7)


@dataclasses.dataclass(frozen=True)
class _Placed(Slab):
    """A slab that reports a device of its own while its tensors stay on
    the CPU: two such "devices" run the route of a mesh of several."""
    where: torch.device = torch.device("cpu")

    @property
    def device(self) -> torch.device:
        return self.where


def _recording(monkeypatch):
    calls = []
    real = hpk.horner_push_slabs_plain

    def record(rows, us, slabs, outs, tau, **kw):
        calls.append((slabs[0].device, len(slabs), kw["hi"], kw["lo"]))
        return real(rows, us, slabs, outs, tau, **kw)

    monkeypatch.setattr(hpk, "horner_push_slabs_plain", record)
    return calls


@pytest.mark.parametrize("bf16", [False, True])
def test_slab_push_routes_by_device(monkeypatch, bf16):
    """Every slab on one device: one call over every level. Slabs on two
    devices: one call a level a device from the top level, the frontier
    exchanged between them, with the one-device route's bits."""
    g, ri, ku, xu, d, blocks, slabs, tau, n_loc = _slab_case("powerlaw", 4)
    l_max = ri.plan.l_max
    keys, vals = torch.as_tensor(ku), torch.as_tensor(xu)
    calls = _recording(monkeypatch)
    one = slab_horner_push(keys, vals, slabs, float(tau), n=g.n,
                           l_max=l_max, bf16_frontier=bf16)
    assert calls == [(torch.device("cpu"), 4, l_max, 0)]
    calls.clear()
    two = [_Placed(**{f.name: getattr(sl, f.name)
                      for f in dataclasses.fields(Slab)},
                   where=torch.device("cpu", s // 2))
           for s, sl in enumerate(slabs)]
    got = slab_horner_push(keys, vals, two, float(tau), n=g.n, l_max=l_max,
                           bf16_frontier=bf16)
    top = top_level(keys, g.n, l_max)
    assert calls == [(torch.device("cpu", i), 2, level, level)
                     for level in range(top, -1, -1) for i in (0, 1)]
    assert torch.equal(torch.cat(got), torch.cat(one))


def test_slab_push_refuses_more_slabs_than_the_cap():
    """Above ``MAX_SLABS`` slabs (or ``MAX_SEGMENTS`` row segments) a
    launch the kernel's route raises before it builds anything; it never
    degrades to another route. The plain version has no parameter table
    and takes them all."""
    from repro_torch.kernels.horner_push.horner_push import _check_caps
    lay = SpmmLayout.from_edges([0], [0], [0.5], 1, "cpu")
    many = [Slab(layout=lay, d=torch.ones(1), start=i, d_offset=i)
            for i in range(MAX_SLABS + 1)]
    row = (torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1)), 0)
    with pytest.raises(ValueError, match=f"1 to {MAX_SLABS} slabs"):
        _check_caps(many, [row])
    with pytest.raises(ValueError, match=f"at most {MAX_SEGMENTS} row"):
        _check_caps(many[:1], [row] * (MAX_SEGMENTS + 1))
    _check_caps(many[:MAX_SLABS], [row] * MAX_SEGMENTS)


@pytest.mark.parametrize("name", ["powerlaw", "sinks"])
def test_cpu_mesh_above_the_slab_cap_matches_the_per_level_route(name):
    """A CPU mesh of more shards than the kernel's slab cap runs the
    plain version over all of them: the slab push equals the per-level
    route, and the sharded engine's answers the one-device push's."""
    S = MAX_SLABS + 1
    g, ri, ku, xu, d, blocks, slabs, tau, n_loc = _slab_case(name, S)
    l_max = ri.plan.l_max
    np.testing.assert_allclose(
        _slabs_plain(ku, xu, slabs, tau, g.n, l_max).numpy(),
        _per_level_push(ku, xu, slabs, tau, g.n, l_max).numpy(), atol=ATOL,
        rtol=0)
    _, _, tg, ti = _cell(name)
    si = tsq.shard_index(ti, tg, _mesh(S))
    np.testing.assert_allclose(tsq.sharded_single_source(si, US),
                               single_source_device(ti, tg, US, device="cpu"),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_pod_path_on_a_2x2_mesh(bf16):
    """``batched_single_source_sharded``: queries over "data", nodes over
    "model", d replicated; float32 equals the one-device push, and the
    bfloat16 exchange stays within its 1 % of each score."""
    from repro_torch.graph import generators
    g = generators.barabasi_albert(128, 3, seed=0, directed=False)
    idx = tbuild.build_index(g, eps=0.2, exact_d=True, device="cpu")
    mesh = tmesh.make_debug_mesh((2, 2), ("data", "model"),
                                 devices=["cpu"] * 4)
    n_l = g.n // 2
    bs, bd, bw = tsq.partition_edges(g, idx.plan.sqrt_c, 2, n_l,
                                     tsq.required_edge_cap(g, 2, n_l) + 3)
    us = np.array([3, 7, 11, 20], np.int32)
    out = batched_single_source_sharded(
        idx.hp.keys, idx.hp.vals, idx.d, bs, bd, bw, us,
        prune_tau(idx.plan), g.n, idx.plan.l_max, mesh,
        bf16_frontier=bf16).numpy()
    # the slabs built once serve a second batch with the same bits
    slabs = pod_slabs(idx.d, bs, bd, bw, g.n, mesh)
    again = batched_single_source_sharded(
        idx.hp.keys, idx.hp.vals, None, None, None, None, us,
        prune_tau(idx.plan), g.n, idx.plan.l_max, mesh,
        bf16_frontier=bf16, slabs=slabs).numpy()
    np.testing.assert_array_equal(again, out)
    want = single_source_device(idx, g, us, device="cpu")
    if bf16:
        assert np.all(np.abs(out - want) <= 0.01 * want + 1e-7)
    else:
        np.testing.assert_array_equal(out, want)
    rg = rgen.barabasi_albert(128, 3, seed=0, directed=False)
    ri = rbuild.build_index(rg, eps=0.2, exact_d=True)
    for i, u in enumerate(us):
        assert np.abs(out[i] - r_horner(ri, rg, int(u))).max() < 2e-3


# ----------------------------------------------------------------------
# the sharded build and walks
# ----------------------------------------------------------------------
def test_check_walk_mesh_and_builder_follow_reference():
    """The same meshes are refused by both packages; under a mesh
    "auto" stays "sling" and "prsim" is refused."""
    g, ri, tg, ti = _cell("powerlaw")
    for S in (1, 2, 3, 4, 6, 8):
        m = _mesh(S)
        for chunk in (1 << 12, 3 << 12):
            refused = []
            for check in (rwalks.check_walk_mesh, twalks.check_walk_mesh):
                try:
                    check(m, "data", chunk)
                    refused.append(False)
                except ValueError:
                    refused.append(True)
            assert refused[0] == refused[1], (S, chunk)
    m = _mesh(2)
    assert tbuild.resolve_builder(tg, "auto", mesh=m) == \
        rbuild.resolve_builder(g, "auto", mesh=m) == ("sling", None)
    for mod, gr in ((tbuild, tg), (rbuild, g)):
        with pytest.raises(ValueError, match="prsim"):
            mod.resolve_builder(gr, "prsim", mesh=m)
    with pytest.raises(ValueError, match="divide"):
        tbuild.build_index(tg, eps=0.3, mesh=_mesh(3))


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("name", ZOO)
def test_shard_build_hp_is_bit_exact(name, S):
    """The sharded table equals the port's one-device table and the
    reference's, bit for bit, with the superblock tail ragged."""
    g, ri, tg, ti = _cell(name)
    p = ri.plan
    got = thp.shard_build_hp(tg, p.theta, p.sqrt_c, p.l_max, _mesh(S),
                             block=8)
    one = thp.build_hp_table(tg, p.theta, p.sqrt_c, p.l_max, block=8,
                             device="cpu")
    ref = rhp.build_hp_table(g, p.theta, p.sqrt_c, p.l_max, block=8)
    for a, b in ((got.keys, one.keys), (got.vals, one.vals),
                 (got.counts, one.counts)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got.keys.numpy(), ref.keys)
    np.testing.assert_array_equal(got.vals.numpy(), ref.vals)


def test_shard_build_hp_spills(tmp_path):
    g, ri, tg, ti = _cell("er")
    p = ri.plan
    spilled = thp.shard_build_hp(tg, p.theta, p.sqrt_c, p.l_max, _mesh(2),
                                 block=8, spill_dir=str(tmp_path))
    held = thp.shard_build_hp(tg, p.theta, p.sqrt_c, p.l_max, _mesh(2),
                              block=8)
    assert sorted(os.listdir(tmp_path))[0].startswith("hp_shard_block_")
    assert torch.equal(spilled.keys, held.keys)
    assert torch.equal(spilled.vals, held.vals)


@pytest.mark.parametrize("name", ZOO)
def test_sharded_walk_diagonal_is_bit_exact(name):
    """``estimate_diagonal(mesh=)`` splits each step's walks over the
    shards from one draw: d equals the unsharded estimate bit for bit,
    within eps_d of the exact diagonal, and so does a mesh build."""
    g, ri, tg, ti = _cell(name)
    p = rtheory.plan(eps=0.1, c=0.6, n=g.n)
    one = tdiagonal.estimate_diagonal(tg, p, seed=4, chunk=1 << 14,
                                      device="cpu")
    for S in (2, 4):
        got = tdiagonal.estimate_diagonal(tg, p, 4, True, 1 << 14,
                                          mesh=_mesh(S))
        np.testing.assert_array_equal(got, one)
    assert np.abs(one - tdiagonal.exact_diagonal(tg, 0.6)).max() <= p.eps_d


def test_build_index_with_a_mesh_equals_the_unsharded_build():
    g, ri, tg, ti = _cell("powerlaw")
    a = tbuild.build_index(tg, 0.2, seed=2, block=16, device="cpu")
    b = tbuild.build_index(tg, 0.2, None, 0.6, 2, True, 16, None, False,
                           False, False, 0.0, 0.0, "auto", _mesh(4), "data")
    assert b.builder == "sling" and b.d.device.type == "cpu"
    for x, y in ((a.d, b.d), (a.hp.keys, b.hp.keys), (a.hp.vals, b.hp.vals)):
        assert torch.equal(x, y)
    p = b.plan
    ref = rhp.build_hp_table(g, p.theta, p.sqrt_c, p.l_max, block=16)
    np.testing.assert_array_equal(b.hp.keys.numpy(), ref.keys)
    np.testing.assert_array_equal(b.hp.vals.numpy(), ref.vals)


# ----------------------------------------------------------------------
# the engine, the join and the CLI under a mesh
# ----------------------------------------------------------------------
def test_engine_mesh_churn_swap_adds_no_shape():
    """A sharded engine against the reference's engine on the same
    index, then a churn batch through ``update_index`` and
    ``swap_index``: no new shape, no bucket growth, answers equal to a
    one-device engine on the repaired index."""
    from repro.serve import EngineConfig as REngineConfig
    from repro.serve import QueryEngine as RQueryEngine
    g, ri, tg, ti = _cell("powerlaw")
    ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                   ri.hp.keys, ri.vals_f32(), ri.hp.counts,
                                   device="cpu")   # its own, to mutate
    cfg = dict(source_batch=4, pair_batch=16, cache_size=0)
    eng = QueryEngine(ti, tg, EngineConfig(mesh=_mesh(4), **cfg))
    reng = RQueryEngine(ri, g, REngineConfig(**cfg))
    eng.warmup()
    before = set(eng.stats()["unique_shapes"])
    assert all(s[-2:] == ("mesh", 4) for s in before if s[0] != "pair")
    us = np.asarray(US, np.int32)
    np.testing.assert_allclose(eng.single_source(us), reng.single_source(us),
                               atol=ATOL, rtol=0)
    rv, ri_ = reng.topk(us, 10)
    tv, tid = eng.topk(us, 10)
    _check_topk(tv, tid, rv, ri_, reng.single_source(us))
    np.testing.assert_allclose(eng.pairs(us, us[::-1]),
                               reng.pairs(us, us[::-1]), atol=ATOL, rtol=0)
    delta = tupdate.random_delta(tg, n_add=6, n_del=6, seed=5)
    rep = tbuild.update_index(ti, tg, delta, exact_d=True)
    sw = eng.swap_index(ti, rep.graph, affected=rep.affected)
    one = QueryEngine(ti, rep.graph, EngineConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(eng.single_source(us), one.single_source(us))
    np.testing.assert_array_equal(eng.topk(us, 10)[1], one.topk(us, 10)[1])
    st = eng.stats()
    assert set(st["unique_shapes"]) == before
    assert sw["recompiles"] == st["swap_recompiles"] == 0
    assert st["mesh_shards"] == 4 and st["device"] == "cpu"


def test_engine_mesh_counts_an_edge_bucket_growth():
    """Edges piled onto one shard past its bucket: the ShardedIndex
    records the grown bucket, while the swap counts no recompile and the
    next batch adds no shape, since the slabs' CSRs take their exact
    sizes; the answers are the one-device engine's on the new graph."""
    from repro_torch.graph import csr as tcsr
    g, ri, tg, ti = _cell("er")
    eng = QueryEngine(ti, tg, EngineConfig(
        source_batch=4, mesh=_mesh(2), cap_quantum=1, swap_headroom=1.0))
    eng.single_source(US)
    before = set(eng.stats()["unique_shapes"])
    pile = tcsr.GraphDelta(
        add_src=np.arange(1, 40, dtype=np.int64),
        add_dst=np.zeros(39, np.int64),
        del_src=np.zeros(0, np.int64), del_dst=np.zeros(0, np.int64))
    g2 = tcsr.apply_edges(tg, pile)[0]
    need = tsq.required_edge_cap(g2, 2, 24)
    assert eng._sharded.edge_cap < need
    assert eng.swap_index(ti, g2)["recompiles"] == 0
    assert eng._sharded.edge_cap == need
    got = eng.single_source(US)
    st = eng.stats()
    assert set(st["unique_shapes"]) == before
    assert st["swap_recompiles"] == 0
    one = QueryEngine(ti, g2, EngineConfig(source_batch=4), device="cpu")
    np.testing.assert_array_equal(got, one.single_source(US))


def test_sharded_join_and_cross_layout_resume(tmp_path):
    """``JoinConfig(mesh=)`` against the one-device sweep and the
    reference's; a checkpoint written under two shards is refused under
    four, and resumes under two to equal bits."""
    g, ri, tg, ti = _cell("powerlaw")
    one = run_join(ti, tg, config=JoinConfig(k=8, tile=16), device="cpu")
    ref = rrun_join(ri, g, config=RJoinConfig(k=8, tile=16))
    ck = str(tmp_path / "j.ckpt.npz")
    cfg2 = JoinConfig(k=8, tile=16, mesh=_mesh(2), checkpoint_path=ck,
                      checkpoint_every=1)
    full = run_join(ti, tg, config=JoinConfig(k=8, tile=16, mesh=_mesh(2)))
    assert full.mesh_shards == 2
    np.testing.assert_array_equal(full.nbr_ids, one.nbr_ids)
    np.testing.assert_allclose(full.nbr_scores, ref.nbr_scores, atol=ATOL,
                               rtol=0)
    assert run_join(ti, tg, config=cfg2, stop_after_tiles=2) is None
    cfg4 = dataclasses.replace(cfg2, mesh=_mesh(4))
    with pytest.raises(ValueError, match="mesh_shards"):
        run_join(ti, tg, config=cfg4)
    resumed = run_join(ti, tg, config=cfg2)
    for f in ("sources", "indptr", "nbr_ids", "nbr_scores"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(full, f))


def test_serve_cli_with_a_mesh(capsys):
    tserve.main(["--device", "cpu", "--n", "120", "--queries", "8",
                 "--mode", "mixed", "--mesh", "2", "--mutate", "1",
                 "--eps", "0.2"])
    out = capsys.readouterr().out
    assert "mesh: 2-way node-sharded serving" in out
    assert "mesh=2" in out and "fixed shape set OK" in out
    assert "fixed-shape swap OK" in out


# ----------------------------------------------------------------------
# the reference's own S > 1 answers (forced host devices)
# ----------------------------------------------------------------------
REF_CASES = ("powerlaw",)   # each case costs the subprocess ~7 s of compiles
REF_4WAY = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = ["src", "tests"]
import numpy as np
import oracle
from repro.core import build, hp_index, shard_query
out = {}
for name in %r:
    g = oracle.cases()[name]
    idx = build.build_index(g, eps=0.1, exact_d=True, seed=0)
    us = np.asarray(%r, np.int32)
    for S in (2, 4):
        si = shard_query.shard_index(idx, g, shard_query.serving_mesh(S))
        out[f"{name}/source/{S}"] = shard_query.sharded_single_source(si, us)
        v, i = shard_query.sharded_topk(si, us, 10)
        out[f"{name}/topv/{S}"], out[f"{name}/topi/{S}"] = v, i
    p = idx.plan
    hp = hp_index.shard_build_hp(g, p.theta, p.sqrt_c, p.l_max,
                                 shard_query.serving_mesh(4), block=8)
    out[f"{name}/keys"], out[f"{name}/vals"] = hp.keys, hp.vals
np.savez(sys.argv[1], **out)
print("REF_4WAY_OK")
""" % (REF_CASES, US)


@pytest.fixture(scope="module")
def ref_4way(tmp_path_factory):
    """The reference's sharded answers and 4-way table, from the one
    subprocess that forces 4 host devices."""
    path = tmp_path_factory.mktemp("ref4") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_4WAY, str(path)],
                       cwd=ROOT, capture_output=True, text=True, env=env,
                       timeout=300)
    assert "REF_4WAY_OK" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", REF_CASES)
def test_sharded_answers_match_the_reference_mesh(ref_4way, name, S):
    g, ri, tg, ti = _cell(name)
    si = tsq.shard_index(ti, tg, _mesh(S))
    us = np.asarray(US, np.int32)
    got = tsq.sharded_single_source(si, us)
    np.testing.assert_allclose(got, ref_4way[f"{name}/source/{S}"],
                               atol=ATOL, rtol=0)
    tv, tid = tsq.sharded_topk(si, us, 10)
    _check_topk(tv, tid, ref_4way[f"{name}/topv/{S}"],
                ref_4way[f"{name}/topi/{S}"], got)


@pytest.mark.parametrize("name", REF_CASES)
def test_shard_build_hp_matches_the_reference_mesh(ref_4way, name):
    g, ri, tg, ti = _cell(name)
    p = ri.plan
    got = thp.shard_build_hp(tg, p.theta, p.sqrt_c, p.l_max, _mesh(4),
                             block=8)
    np.testing.assert_array_equal(got.keys.numpy(), ref_4way[f"{name}/keys"])
    np.testing.assert_array_equal(got.vals.numpy(), ref_4way[f"{name}/vals"])
