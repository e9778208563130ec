"""The port's index build held against the JAX reference on the oracle
zoo: the dense Alg-2 HP table (keys equal, values to 1e-5, entries
within float32 rounding of theta counted), ``build_index(exact_d=True)``,
the pair queries on the result, and the Alg-4 walk diagonal held to
its certificate |d~ - d| <= eps_d. ``build_index``, the diagonal and
HP-table builders, ``SlingIndex`` and ``EngineConfig`` take the
reference's positional order."""
import ast
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.core import diagonal as rdiagonal
from repro.core import hp_index as rhp
from repro.core import theory as rtheory
from repro.core import walks as rwalks
from repro.core.index import SlingIndex as RIndex
from repro.kernels.cin import ops as rcin_ops
from repro.kernels.hp_join.hp_join import hp_join as rhp_join
from repro.kernels.hp_join import ops as rhp_ops
from repro.kernels.hp_join.ref import join_ref as rjoin_ref
from repro.kernels.spmv_ell.ref import spmm_ref as rspmm_ref
from repro.launch import hlo_analysis as rhlo_analysis
from repro.launch import mesh as rmesh
from repro.launch import sharding as rsharding
from repro.launch import specs as rspecs
from repro.models import gnn_sharded as rgnn_sharded
from repro.models import moe as rmoe
from repro.models import recsys as rrecsys
from repro.serve import EngineConfig as REngineConfig
from repro.train import checkpoint as rcheckpoint
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core import diagonal as tdiagonal
from repro_torch.core import hp_index as thp
from repro_torch.core.index import SlingIndex as TIndex
from repro_torch.serve import EngineConfig as TEngineConfig
from repro_torch.core import theory as ttheory
from repro_torch.core import walks as twalks
from repro_torch.graph import generators as tgen
from repro_torch.kernels.cin import ops as tcin_ops
from repro_torch.kernels.hp_join import hp_join as thp_join
from repro_torch.kernels.hp_join import ops as thp_ops
from repro_torch.kernels.hp_join.ref import join_ref as tjoin_ref
from repro_torch.kernels.spmv_ell.ref import spmm_ref as tspmm_ref
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import hlo_analysis as thlo_analysis
from repro_torch.launch import inspect_cell as tinspect_cell
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import specs as tspecs
from repro_torch.models import gnn_sharded as tgnn_sharded
from repro_torch.models import moe as tmoe
from repro_torch.train import checkpoint as tcheckpoint
from repro_torch.models import recsys as trecsys

ZOO = tuple(oracle.cases())
ATOL = 1e-5


def _graphs(name):
    r = oracle.cases()[name]
    return r, convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)


def _entries(keys, vals):
    """{(row, key): value} of a packed table."""
    rows, cols = np.nonzero(keys != rhp.INT32_PAD_KEY)
    return dict(zip(zip(rows.tolist(), keys[rows, cols].tolist()),
                    vals[rows, cols].tolist()))


@pytest.mark.parametrize("eps", [0.1, 0.05])
@pytest.mark.parametrize("name", ZOO)
def test_hp_table_matches_reference(name, eps):
    r, t = _graphs(name)
    p = rtheory.plan(eps=eps, c=0.6, n=r.n)
    ref = rhp.build_hp_table(r, p.theta, p.sqrt_c, p.l_max, block=16)
    got = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=16,
                             device="cpu")
    e_ref = _entries(ref.keys, ref.vals)
    e_got = _entries(got.keys.numpy(), got.vals.numpy())
    # entries on one side only must sit within float32 rounding of theta
    only = [(k, v) for k, v in e_ref.items() if k not in e_got] + \
        [(k, v) for k, v in e_got.items() if k not in e_ref]
    boundary = [k for k, v in only if abs(v - p.theta) <= 4e-7 * p.theta]
    assert len(boundary) == len(only), only
    assert len(only) <= 0.001 * len(e_ref)
    shared = [k for k in e_ref if k in e_got]
    np.testing.assert_allclose([e_got[k] for k in shared],
                               [e_ref[k] for k in shared], atol=ATOL, rtol=0)
    if not only:
        np.testing.assert_array_equal(got.keys.numpy(), ref.keys)
        np.testing.assert_array_equal(got.counts.numpy(), ref.counts)
        assert got.width == ref.width


def test_hp_table_block_size_does_not_change_entries():
    _, t = _graphs("powerlaw")
    p = ttheory.plan(eps=0.05, c=0.6, n=t.n)
    a = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=7,
                           device="cpu")
    b = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=64,
                           device="cpu")
    assert torch.equal(a.keys, b.keys) and torch.equal(a.vals, b.vals)
    assert a.entries(5) == [(k // t.n, k % t.n, v) for k, v in zip(
        a.keys[5, :int(a.counts[5])].tolist(),
        a.vals[5, :int(a.counts[5])].tolist())]


def test_capacity_bucket_matches_reference():
    for x in (0, 1, 50, 51, 64, 1000, 4097):
        assert thp.capacity_bucket(x) == rhp.capacity_bucket(x)


@pytest.fixture(scope="module")
def built():
    out = {}
    for name in ZOO:
        r, t = _graphs(name)
        out[name] = (rbuild.build_index(r, eps=0.1, exact_d=True),
                     tbuild.build_index(t, eps=0.1, exact_d=True,
                                        device="cpu"))
    return out


@pytest.mark.parametrize("name", ZOO)
def test_build_index_exact_d_matches_reference(built, name):
    ri, ti = built[name]
    assert ti.plan == convert.index_from_arrays(
        __import__("dataclasses").asdict(ri.plan), ri.d, ri.hp.keys,
        ri.vals_f32(), ri.hp.counts, device="cpu").plan
    np.testing.assert_allclose(ti.d.numpy(), ri.d, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ti.hp.keys.numpy(), ri.hp.keys)
    np.testing.assert_allclose(ti.hp.vals.numpy(), ri.hp.vals, atol=ATOL,
                               rtol=0)
    assert ti.build_seconds.keys() == {"d", "hp"}


PLAN_ARGS = (0.1, 1e-3, 0.5)     # eps, delta, c: c = 0.001 if misread


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_build_index_argument_order_matches_reference(how):
    """``build_index(g, eps, delta, c)`` reads its arguments as the
    reference does, by position and by keyword: the plan equals the
    reference build's and ``theory.plan``'s, field for field."""
    r, t = _graphs("powerlaw")
    eps, delta, c = PLAN_ARGS
    if how == "positional":
        ti = tbuild.build_index(t, eps, delta, c, exact_d=True,
                                device="cpu")
        ri = rbuild.build_index(r, eps, delta, c, exact_d=True)
    else:
        ti = tbuild.build_index(t, eps=eps, delta=delta, c=c, exact_d=True,
                                device="cpu")
        ri = rbuild.build_index(r, eps=eps, delta=delta, c=c, exact_d=True)
    want = dataclasses.asdict(rtheory.plan(eps=eps, delta=delta, c=c,
                                           n=r.n))
    assert dataclasses.asdict(ri.plan) == want
    got = dataclasses.asdict(ti.plan)
    assert got == {k: want[k] for k in got}
    assert ti.plan.c == c and ti.plan.delta == delta
    np.testing.assert_array_equal(ti.hp.keys.numpy(), ri.hp.keys)


def test_build_index_passes_delta_and_adaptive_to_the_walks(monkeypatch):
    """A positional ``delta`` reaches the plan that sizes the walks, and
    a positional ``adaptive`` reaches ``estimate_diagonal``: the build's
    d equals a direct Algorithm-1 estimate on the same seed."""
    _, t = _graphs("powerlaw")
    seen = []
    real = tdiagonal.estimate_diagonal

    def spy(g, plan, seed=0, adaptive=True, **kw):
        seen.append((plan, seed, adaptive))
        return real(g, plan, seed=seed, adaptive=adaptive, **kw)

    monkeypatch.setattr(tbuild.diagonal, "estimate_diagonal", spy)
    idx = tbuild.build_index(t, 0.3, 0.01, 0.6, 5, False, 16, device="cpu")
    (plan, seed, adaptive), = seen
    assert plan == idx.plan and plan.delta == 0.01 and seed == 5
    assert adaptive is False
    assert plan.n_r1 != ttheory.plan(eps=0.3, c=0.6, n=t.n).n_r1
    monkeypatch.undo()
    direct = tdiagonal.estimate_diagonal(t, plan, seed=5, adaptive=False,
                                         device="cpu")
    np.testing.assert_array_equal(idx.d.numpy(), direct)


def test_build_index_takes_nothing_positional_after_block():
    """The reference's positional parameters run through ``mesh_axis``
    (``spill_dir`` eighth, ``builder`` fourteenth, ``mesh`` fifteenth),
    which the port takes in the same order; its own ``device`` and
    ``verbose`` are keyword-only, so a seventeenth positional argument
    is refused."""
    _, t = _graphs("powerlaw")
    args = (0.1, None, 0.6, 0, True, 16, None, False, False, True, 0.0,
            0.0, "sling", None, "data")
    assert tbuild.build_index(t, *args, device="cpu").builder == "sling"
    with pytest.raises(TypeError):
        tbuild.build_index(t, *args, "cpu")


# the port's own parameters, keyword-only after the reference's
PORT_KEYWORDS = {"device", "verbose", "build_seconds", "read_only"}
# and those of one function only
OWN_KEYWORDS = {"cin": {"backend"}, "cin_forward": {"backend"},
                "paired_meet": {"mesh", "mesh_axis"},
                "make_production_mesh": {"multi_pod", "devices"},
                "run_cell": {"mesh"},
                "Roofline": {"compute_s_per_device"}}
# a positional the port renames by design: a torch.Generator for a key
RENAMED = {"paired_meet": {"key": "gen"}}
# trailing reference parameters the port has no use for: an XLA compile
# control, a positional verbose it takes by keyword, Pallas tiling
DROPPED = {"fused", "verbose", "bb", "interpret"}


def _positional(fn):
    """(positional parameter names, keyword-only names) of a function or
    a dataclass's __init__."""
    ps = inspect.signature(fn).parameters.values()
    return ([p.name for p in ps if p.kind == p.POSITIONAL_OR_KEYWORD],
            {p.name for p in ps if p.kind == p.KEYWORD_ONLY})


def _from_source(rel: str, name: str):
    """A stub with the signature of the reference's function ``name`` in
    ``src/repro/<rel>``, read without importing the module (the dry run
    and the inspector set XLA_FLAGS when they are imported, which would
    change the device count of JAX in this process)."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "src" / "repro"
                      / rel).read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {}
    exec(f"def {name}({ast.unparse(node.args)}): pass", ns)
    return ns[name]


def _gathered_rows_call(port):
    """The reference's ``hp_join(ku, vu, kv, vv)`` on gathered rows."""
    k = torch.zeros((4, 8), dtype=torch.int32)
    v = torch.zeros((4, 8))
    return port(k, v, k, v)


SIGNATURES = {
    "estimate_diagonal": (rdiagonal.estimate_diagonal,
                          tdiagonal.estimate_diagonal),
    "estimate_diagonal_chunked": (rdiagonal.estimate_diagonal_chunked,
                                  tdiagonal.estimate_diagonal_chunked),
    "build_hp_table": (rhp.build_hp_table, thp.build_hp_table),
    "repair_hp_rows": (rhp.repair_hp_rows, thp.repair_hp_rows),
    "shard_build_hp": (rhp.shard_build_hp, thp.shard_build_hp),
    "build_index": (rbuild.build_index, tbuild.build_index),
    "resolve_builder": (rbuild.resolve_builder, tbuild.resolve_builder),
    "SlingIndex": (RIndex, TIndex),
    "EngineConfig": (REngineConfig, TEngineConfig),
    "from_graph": (rwalks.DeviceGraph.from_graph,
                   twalks.DeviceGraph.from_graph),
    "cin": (rrecsys.cin, trecsys.cin),
    "cin_forward": (rcin_ops.cin_forward, tcin_ops.cin_forward),
    "paired_meet": (rwalks.paired_meet, twalks.paired_meet),
    "fold_sqrt_d": (rhp_ops.fold_sqrt_d, thp_ops.fold_sqrt_d),
    "hp_join": (rhp_join, thp_join),
    "restore": (rcheckpoint.restore, tcheckpoint.restore),
    "moe_ffn": (rmoe.moe_ffn, tmoe.moe_ffn),
    "gcn_loss_sharded": (rgnn_sharded.gcn_loss_sharded,
                         tgnn_sharded.gcn_loss_sharded),
    "build_sharded_gcn_batch": (rgnn_sharded.build_sharded_gcn_batch,
                                tgnn_sharded.build_sharded_gcn_batch),
    "spec_for": (rsharding.spec_for, tsharding.spec_for),
    "param_spec": (rsharding.param_spec, tsharding.param_spec),
    "make_production_mesh": (rmesh.make_production_mesh,
                             tmesh.make_production_mesh),
    "join_ref": (rjoin_ref, tjoin_ref),
    "spmm_ref": (rspmm_ref, tspmm_ref),
    "make_cell": (rspecs.make_cell, tspecs.make_cell),
    "run_cell": (_from_source("launch/dryrun.py", "run_cell"),
                 tdryrun.run_cell),
    "inspect": (_from_source("launch/inspect_cell.py", "inspect"),
                tinspect_cell.inspect),
    "Roofline": (rhlo_analysis.Roofline, thlo_analysis.Roofline),
}
# refused by design, with TypeError: the gathered-row join (the port's
# kernel gathers the rows itself; ROADMAP.md, "Not ported, by design")
REFUSED = {"hp_join": _gathered_rows_call}


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_positional_order_matches_reference(name):
    """Each repaired signature reads its positional arguments as the
    reference does: the port's positional names are the reference's, in
    its order (``RENAMED`` aside), up to the port's own keyword-only
    parameters. The port drops only trailing reference parameters it
    has no use for (``DROPPED``). A form the port refuses by design
    (``REFUSED``) raises ``TypeError`` when called by the reference's
    positions."""
    ref, port = SIGNATURES[name]
    if name in REFUSED:
        with pytest.raises(TypeError):
            REFUSED[name](port)
        return
    r_pos, _ = _positional(ref)
    t_pos, t_kw = _positional(port)
    renamed = RENAMED.get(name, {})
    r_pos = [renamed.get(p, p) for p in r_pos]
    assert t_pos == r_pos[:len(t_pos)]
    assert set(r_pos[len(t_pos):]) <= DROPPED
    assert t_kw <= PORT_KEYWORDS | OWN_KEYWORDS.get(name, set())


def test_roofline_reads_the_reference_positions():
    """``Roofline``'s eight positional fields are the reference's:
    ``arg_bytes``, ``temp_bytes`` and ``out_bytes`` sixth to eighth, and
    the port's walked compute seconds only by keyword (a ninth
    positional is refused)."""
    args = (1e12, 1e9, 0.0, 1, 1e12, 5e9, 1e9, 2e9)
    ref = rhlo_analysis.Roofline(*args)
    port = thlo_analysis.Roofline(*args, compute_s_per_device=0.25)
    for f in ("arg_bytes", "temp_bytes", "out_bytes", "flops_per_device",
              "hbm_bytes_per_device", "n_devices", "model_flops"):
        assert getattr(port, f) == getattr(ref, f), f
    assert (port.arg_bytes, port.temp_bytes, port.out_bytes) == \
        (5e9, 1e9, 2e9)
    assert port.t_compute == 0.25
    with pytest.raises(TypeError):
        thlo_analysis.Roofline(*args)
    with pytest.raises(TypeError):
        thlo_analysis.Roofline(*args, 0.25)


@pytest.mark.parametrize("package", ["core", "configs"])
def test_package_names_match_reference(package):
    """``repro_torch.core`` and ``repro_torch.configs`` export the
    reference packages' public names (``build_index``, ``update_index``,
    ``SlingIndex``, ``plan``; ``all_archs``, ``get``), each bound to the
    port's own object."""
    import importlib

    def public(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and not inspect.ismodule(v)}

    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    assert public(port) == public(ref)
    for n in public(port):
        assert getattr(port, n).__module__.startswith("repro_torch."), n


def test_from_graph_and_paired_meet_by_position(monkeypatch):
    """The reference's calls ``DeviceGraph.from_graph(g, edge_cap)`` and
    ``paired_meet(in_ptr, in_idx, in_deg, a, b, key, sqrt_c, t_max)``:
    a padded edge capacity leaves the walks' bits as they were, a
    capacity below m is refused, and without a card ``from_graph(g)``
    raises rather than run on the CPU."""
    g = tgen.multigraph(32, 90, seed=9)
    rng = np.random.default_rng(3)
    sa = torch.as_tensor(rng.integers(0, g.n, 500))
    sb = torch.as_tensor(rng.integers(0, g.n, 500))
    met = []
    for cap in (None, 4096):
        dg = twalks.DeviceGraph.from_graph(g, cap, device="cpu")
        assert dg.in_idx.numel() == (cap or g.m) + 1
        met.append(twalks.paired_meet(dg.in_ptr, dg.in_idx, dg.in_deg, sa,
                                      sb, torch.Generator().manual_seed(4),
                                      0.7746, 12))
    assert torch.equal(met[0], met[1]) and met[0].any()
    with pytest.raises(ValueError):
        twalks.DeviceGraph.from_graph(g, g.m - 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twalks.DeviceGraph.from_graph(g)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cin_by_position_equals_reference(use_kernel):
    """``cin(x0, w, use_kernel)`` by position: both choices agree with
    the reference's einsum CIN on the CPU; ``use_kernel=False`` refuses
    the kernel's backend, and ``cin_forward(x0, w, 64)`` (the
    reference's ``bb``) raises TypeError."""
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(6, 5, 4)).astype(np.float32)
    ws = [rng.normal(size=(3, 5, 5)).astype(np.float32),
          rng.normal(size=(2, 3, 5)).astype(np.float32)]
    got = trecsys.cin(torch.as_tensor(x0), [torch.as_tensor(w) for w in ws],
                      use_kernel)
    ref = np.asarray(rrecsys.cin(x0, ws, False))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError):
        trecsys.cin(torch.as_tensor(x0), [torch.as_tensor(w) for w in ws],
                    False, backend="auto")
    with pytest.raises(TypeError):
        tcin_ops.cin_forward(torch.as_tensor(x0),
                             [torch.as_tensor(w) for w in ws], 64)


@pytest.mark.parametrize("name", ZOO)
def test_fold_sqrt_d_of_an_index_equals_reference(built, name):
    """``fold_sqrt_d(index)`` returns the reference's (keys, folded)
    with equal bits, on the device asked for."""
    ri, ti = built[name]
    rk, rf = rhp_ops.fold_sqrt_d(ri)
    tk, tf = thp_ops.fold_sqrt_d(ti, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), rk)
    np.testing.assert_array_equal(tf.numpy(), rf)


def test_estimate_diagonal_subset_by_position():
    """The reference's call ``estimate_diagonal(g, plan, 0, True, 1 << 19,
    None, [1, 5, 7], d0)``: nodes 1, 5 and 7 are re-estimated (within
    eps_d of the exact diagonal), every other node keeps d0's bits."""
    g = tgen.barabasi_albert(40, 3, seed=1)
    p = ttheory.plan(0.1, c=0.6, n=40)
    d0 = np.full(40, 0.5, np.float32)
    d = tdiagonal.estimate_diagonal(g, p, 0, True, 1 << 19, None,
                                    [1, 5, 7], d0, device="cpu")
    rest = np.setdiff1d(np.arange(40), [1, 5, 7])
    np.testing.assert_array_equal(d[rest], d0[rest])
    assert (d[[1, 5, 7]] != 0.5).all()
    exact = tdiagonal.exact_diagonal(g, 0.6)
    assert np.abs(d[[1, 5, 7]] - exact[[1, 5, 7]]).max() <= p.eps_d


def test_repair_hp_rows_takes_progress(capsys):
    """``repair_hp_rows(..., block, progress)`` prints its blocks, as the
    reference's does, and repairs the same rows either way."""
    _, t = _graphs("powerlaw")
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    a = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, device="cpu")
    b = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, device="cpu")
    rows, targets = np.arange(t.n), np.arange(0, t.n, 3)
    thp.repair_hp_rows(t, a, rows, targets, 4, True)
    assert "repair block 0/" in capsys.readouterr().out
    thp.repair_hp_rows(t, b, rows, targets, 4)
    assert torch.equal(a.keys, b.keys) and torch.equal(a.vals, b.vals)


@pytest.mark.parametrize("name", ZOO)
def test_pair_queries_match_reference(built, name):
    ri, ti = built[name]
    rng = np.random.default_rng(0)
    us = rng.integers(0, ri.n, 64)
    vs = rng.integers(0, ri.n, 64)
    np.testing.assert_allclose(ti.query_pairs(us, vs, device="cpu"),
                               ri.query_pairs(us, vs), atol=ATOL, rtol=0)
    for u, v in zip(us[:8], vs[:8]):
        assert ti.query_pair_host(int(u), int(v)) == pytest.approx(
            ri.query_pair_host(int(u), int(v)), abs=1e-9)


@pytest.mark.parametrize("name", ZOO)
def test_walk_diagonal_within_eps_d(name):
    _, t = _graphs(name)
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    exact = tdiagonal.exact_diagonal(t, 0.6)
    d = tdiagonal.estimate_diagonal(t, p, seed=11, device="cpu",
                                    chunk=1 << 16)
    assert d.dtype == np.float32 and d.shape == (t.n,)
    assert np.abs(d - exact).max() <= p.eps_d
    deg = t.in_deg
    np.testing.assert_array_equal(d[deg == 0], 1.0)
    np.testing.assert_allclose(d[deg == 1], 0.4, atol=1e-7)


def test_alg1_diagonal_within_eps_d():
    _, t = _graphs("powerlaw")
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    d = tdiagonal.estimate_diagonal(t, p, seed=3, adaptive=False,
                                    device="cpu")
    assert np.abs(d - tdiagonal.exact_diagonal(t, 0.6)).max() <= p.eps_d


def test_walk_diagonal_is_deterministic_in_seed():
    g = tgen.barabasi_albert(40, 3, seed=2, directed=False)
    p = ttheory.plan(eps=0.1, c=0.6, n=g.n)
    a = tdiagonal.estimate_diagonal(g, p, seed=5, device="cpu")
    b = tdiagonal.estimate_diagonal(g, p, seed=5, device="cpu")
    c = tdiagonal.estimate_diagonal(g, p, seed=5, device="cpu",
                                    chunk=1 << 12)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() <= 2 * p.eps_d


def test_paired_meet_semantics():
    g = tgen.with_sinks(30, 80, n_sinks=4, seed=1)
    dg = twalks.DeviceGraph.from_graph(g, device="cpu")
    gen = torch.Generator().manual_seed(0)
    sinks = torch.as_tensor(np.flatnonzero(g.in_deg == 0))
    # identical starts meet at step 0; two distinct sinks never move
    same = twalks.paired_meet(dg.in_ptr, dg.in_idx, dg.in_deg, sinks, sinks,
                              gen, 0.77, 20)
    assert bool(same.all())
    apart = twalks.paired_meet(dg.in_ptr, dg.in_idx, dg.in_deg, sinks[:2],
                               sinks[1:3], gen, 0.77, 20)
    assert not bool(apart.any())


def test_meeting_rate_estimates_simrank():
    """Lemma 3: the fraction of walk pairs that meet is s(u, v)."""
    r, t = _graphs("powerlaw")
    S = oracle.exact_simrank(r, 0.6)
    dg = twalks.DeviceGraph.from_graph(t, device="cpu")
    gen = torch.Generator().manual_seed(1)
    W = 200_000
    met = twalks.paired_meet(dg.in_ptr, dg.in_idx, dg.in_deg,
                             torch.full((W,), 3), torch.full((W,), 9),
                             gen, 0.6 ** 0.5, twalks.default_t_max(0.6 ** 0.5))
    assert abs(met.double().mean().item() - S[3, 9]) < 0.005
