"""The partitioned GNN train step (``models/gnn_sharded.value_and_grad``,
``train/steps.gnn_train_step_sharded``) held against the JAX reference's
unpartitioned functions on the CPU, at ``smoke()`` sizes on graphs of 64
nodes, on meshes of ``["cpu"] * 4`` at (2, 2), (1, 4) and (4, 1) (GSPMD
does not change the function, so the reference runs with no mesh); then
the GNN cell through ``Cell.jitted`` and its dry run on a fake (4, 4)
mesh.

The same numpy-seeded batch (a Barabasi-Albert graph plus an isolated
node and three masked ones, padded edges with mask 0 aimed at node 0)
and the reference's ``init_params``, carried by
``convert.gnn_params_from_jax``, go through ``jax.value_and_grad`` of the
reference's ``loss_fn``, the port's unpartitioned ``value_and_grad`` and
the partitioned step: the loss within TOL = 1e-5 of the reference's, each
leaf's gradient (every position's copy) within TOL of its max |g| against
both. PNA runs on a multigraph whose parallel edges into one destination
lie in two edge slices, so a positive tie of its max and min aggregators
spans positions. The full PNA's reference gradient is NaN wherever a
node's messages are equal in a channel (its std aggregator's sqrt at 0;
the port gives those entries a zero gradient, ``models/gnn.py``): those
entries are skipped in the leaves PNA_REF_NAN names, and the std-free
PNA ("pna-no-std") is held on every entry.
"""
import copy
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.graph import generators as rgen
from repro.models import gnn as RG
from repro.train import checkpoint as rckpt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import collectives as C
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import gnn as TG
from repro_torch.models import gnn_sharded as GS
from repro_torch.models import layers as TL
from repro_torch.models.transformer_sharded import place_params
from repro_torch.optim import adamw as tadamw
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import value_and_grad as port_vg

KINDS = ("gcn-cora", "gat-cora", "pna", "pna-no-std", "graphcast")
MESHES = ((2, 2), (1, 4), (4, 1))
TOL = 1e-5
N = 64
NO_STD = ("mean", "max", "min")
# the full PNA's reference gradient has NaN entries in these leaves (all
# of w_pre/0 and w_post/0, 40 of w_pre/1's 64)
PNA_REF_NAN = {"gnn/w_pre/0", "gnn/w_pre/1", "gnn/w_post/0"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ops here are tiny and dispatch-bound: one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]
# the full PNA's eager reference (~10 s), computed in a subprocess while
# the dry-run cases run first
PNA_REF = """
import sys
sys.path[:0] = [sys.argv[2], sys.argv[3]]
import numpy as np
import test_torch_gnn_mesh as T
loss, grads = T._reference("pna")
np.savez(sys.argv[1], loss=loss, **{n.replace("/", "|"): g
                                    for n, g in grads.items()})
"""


@pytest.fixture(autouse=True, scope="module")
def pna_run(tmp_path_factory):
    """The full PNA's reference subprocess, started with the module's
    first test; read by ``_reference_of``."""
    out = tmp_path_factory.mktemp("pna_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", PNA_REF, str(out), str(ROOT / "src"),
         str(ROOT / "tests")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _reference_of(kind, run):
    """``_reference(kind)``, the full PNA's from the subprocess."""
    if kind != "pna":
        return _reference(kind)
    out, proc = run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-2000:]
    with np.load(out) as z:
        return float(z["loss"]), {k.replace("|", "/"): z[k] for k in z.files
                                  if k != "loss"}


def _configs(kind):
    arch = "pna" if kind == "pna-no-std" else kind
    r, t = rbase.get(arch).smoke(), tbase.get(arch).smoke()
    if kind == "pna-no-std":
        r = dataclasses.replace(r, aggregators=NO_STD)
        t = dataclasses.replace(t, aggregators=NO_STD)
    return r, t


def _edges(kind):
    """(src, dst) of the kind's graph over N nodes: BA(60, 2), or for PNA
    a multigraph whose parallel pair 5 -> 61 (node 61's only in-edges)
    has one edge in the first quarter of the edges and one in the last."""
    g = rgen.barabasi_albert(60, 2, seed=0, directed=False)
    src, dst = list(g.edge_src), list(g.edge_dst)
    if kind.startswith("pna"):
        m = rgen.multigraph(40, 90, seed=9)
        src, dst = [5] + list(m.edge_src) + [5], [61] + list(m.edge_dst) \
            + [61]
    return np.asarray(src, np.int32), np.asarray(dst, np.int32)


@functools.lru_cache(maxsize=None)
def _batch(kind, seed=0):
    """N nodes (the last three masked, node 60 isolated), the edges and
    8 to 11 padded ones (mask 0, src = dst = 0) to a multiple of 4;
    graphcast's grid / mesh arrays as the CLI makes them."""
    rcfg, _ = _configs(kind)
    rng = np.random.default_rng(seed)
    src, dst = _edges(kind)
    pads = 8 + (-(len(src) + 8)) % 4
    z = np.zeros(pads, np.int32)
    b = {"feats": rng.normal(size=(N, rcfg.d_in)).astype(np.float32),
         "edge_src": np.concatenate([src, z]),
         "edge_dst": np.concatenate([dst, z]),
         "edge_mask": np.r_[np.ones(len(src)), z].astype(np.float32),
         "node_mask": np.r_[np.ones(N - 3), np.zeros(3)].astype(np.float32),
         "labels": rng.integers(0, max(rcfg.n_classes, 1), N).astype(
             np.int32)}
    if rcfg.kind == "graphcast":
        h = N // 2
        b.update({"n_grid": np.int32(h),
                  "g2m_src": rng.integers(0, h, N).astype(np.int32),
                  "g2m_dst": rng.integers(h, N, N).astype(np.int32),
                  "g2m_mask": np.ones(N, np.float32),
                  "m2g_src": rng.integers(h, N, N).astype(np.int32),
                  "m2g_dst": rng.integers(0, h, N).astype(np.int32),
                  "m2g_mask": np.ones(N, np.float32),
                  "targets": rng.normal(size=(N, rcfg.n_vars)).astype(
                      np.float32)})
        del b["labels"]
    return b


@functools.lru_cache(maxsize=None)
def _ref_params(kind):
    rcfg, _ = _configs(kind)
    return RG.init_params(rcfg, jr.PRNGKey(0))


def _model(kind):
    _, tcfg = _configs(kind)
    return convert.gnn_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, _ref_params(kind)),
        device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """(loss, {leaf: gradient}) of the reference's ``loss_fn``: eager for
    the full PNA (its variance cancels near 0, where XLA's fused rounding
    moves sqrt), jitted otherwise, as ``tests/test_torch_gnn.py``."""
    rcfg, _ = _configs(kind)
    vg = jax.value_and_grad(lambda p, b: RG.loss_fn(rcfg, p, b))
    if kind != "pna":
        vg = jax.jit(vg)
    loss, grads = vg(_ref_params(kind),
                     {k: jnp.asarray(v) for k, v in _batch(kind).items()})
    names, leaves, _ = rckpt._flatten(grads)
    return float(loss), {n: np.asarray(g) for n, g in zip(names, leaves)}


@functools.lru_cache(maxsize=None)
def _port(kind):
    _, tcfg = _configs(kind)
    loss, grads = port_vg(lambda p, b: TG.loss_fn(tcfg, p, b), _model(kind),
                          _batch(kind))
    return float(loss), {n: g.numpy() for n, g in grads.items()}


def _mesh(shape):
    return make_debug_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _rel(got, ref) -> float:
    """max |got - ref| / max |ref| over the entries where ref is finite
    (0 where none is)."""
    ok = np.isfinite(ref)
    if not ok.any():
        return 0.0
    ref = np.asarray(ref, np.float64)[ok]
    return float(np.abs(np.asarray(got, np.float64)[ok] - ref).max()
                 / max(float(np.abs(ref).max()), 1e-30))


def _placed_state(opt, model, mesh):
    state = opt.init(model)
    shards = sh.tree_shardings(model, mesh)
    return tadamw.AdamWState(
        step=sh.place(state.step, (), mesh),
        m={n: shards[n].shard(t) for n, t in state.m.items()},
        v={n: shards[n].shard(t) for n, t in state.v.items()})


# ----------------------------------------------------------- the cells

TINY = {"full_graph_sm": dict(n=500, m=1900, d_feat=12),
        "minibatch_lg": dict(n=900, m=1000, d_feat=12),
        "ogb_products": dict(n=1000, m=3000, d_feat=12),
        "molecule": dict(n=400, m=900, d_feat=12)}


def _patch(monkeypatch):
    """The GNN archs' ``full()`` replaced by their smoke configs (one
    layer but GAT's two: a fake trace's ops cost ~1 ms each) and the GNN
    shapes by tiny ones."""
    for arch in ("gcn-cora", "gat-cora", "pna", "graphcast"):
        spec = tbase.get(arch)
        small = spec.smoke()
        if arch != "gat-cora":
            small = dataclasses.replace(small, n_layers=1)
        monkeypatch.setitem(tbase._REGISTRY, arch, dataclasses.replace(
            spec, full=lambda small=small: small))
    monkeypatch.setattr(specs, "GNN_SHAPE_DEFS", TINY)


def _cell_args(cell, arch, seed=0):
    """Real arguments of ``cell``'s tree: the config's params, AdamW's
    state and a batch of uniform edges (the last 100 masked)."""
    cfg = dataclasses.replace(tbase.get(arch).full(), d_in=12)
    rng = np.random.default_rng(seed)
    spec = cell.args[2]
    n, m = spec["feats"].shape[0], spec["edge_src"].shape[0]
    b = {"feats": rng.normal(size=(n, 12)).astype(np.float32),
         "edge_src": rng.integers(0, n, m).astype(np.int32),
         "edge_dst": rng.integers(0, n, m).astype(np.int32),
         "edge_mask": (np.arange(m) < m - 100).astype(np.float32),
         "node_mask": (rng.random(n) < 0.9).astype(np.float32),
         "labels": rng.integers(0, max(cfg.n_classes, 1), n).astype(
             np.int32)}
    if cfg.kind == "graphcast":
        h = n // 2
        b.update({"n_grid": np.int32(h),
                  "g2m_src": rng.integers(0, h, m).astype(np.int32),
                  "g2m_dst": rng.integers(h, n, m).astype(np.int32),
                  "g2m_mask": np.ones(m, np.float32),
                  "m2g_src": rng.integers(h, n, m).astype(np.int32),
                  "m2g_dst": rng.integers(0, h, m).astype(np.int32),
                  "m2g_mask": np.ones(m, np.float32),
                  "targets": rng.normal(size=(n, cfg.n_vars)).astype(
                      np.float32)})
    batch = {k: torch.as_tensor(b[k][:spec[k].shape[0]] if b[k].ndim
                                else b[k]) for k in spec}
    model = TG.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    return model, tadamw.AdamW(lr=1e-3).init(model), batch


@pytest.mark.parametrize("arch", ["pna", "graphcast"])
def test_gnn_cell_reads_pieces_and_equals_the_direct_step(monkeypatch,
                                                         arch):
    """``_gnn_cell`` marks its arguments piecewise: ``Cell.jitted`` over
    the placed real arguments runs the partitioned step, equal bits to
    calling it directly, and the loss is the unpartitioned one's."""
    _patch(monkeypatch)
    mesh = _mesh((2, 2))
    cell = specs.make_cell(arch, "ogb_products", mesh)
    assert cell.piecewise == (0, 1, 2)
    cfg = dataclasses.replace(tbase.get(arch).full(), d_in=12)
    args = _cell_args(cell, arch)
    a, b = copy.deepcopy(args), copy.deepcopy(args)
    pa, _, out = cell.jitted()(*cell.place(a))
    opt = tadamw.AdamW(lr=1e-3)
    with sh.use_mesh_rules(mesh, cell.rules):
        pb = place_params(b[0])
        _, _, ref = tsteps.gnn_train_step_sharded(cfg, opt)(
            pb, _placed_state(opt, b[0], mesh), b[2])
    assert torch.equal(out["loss"], ref["loss"])
    for n, st in pa.items():
        assert torch.equal(st.gather(), pb[n].gather()), n
    whole = TG.loss_fn(cfg, args[0], args[2])
    assert abs(float(out["loss"]) - float(whole)) <= TOL * abs(float(whole))


def _gathered(cell, arch):
    """The same cell on the gathered path: the unpartitioned step, every
    argument gathered to the mesh's first device."""
    cfg = dataclasses.replace(tbase.get(arch).full(),
                              d_in=TINY[cell.shape_name]["d_feat"])
    return dataclasses.replace(
        cell, fn=tsteps.gnn_train_step(cfg, tadamw.AdamW(lr=1e-3)),
        piecewise=())


@pytest.mark.parametrize("arch", ["gcn-cora", "gat-cora", "pna",
                                  "graphcast"])
def test_dry_run_reads_pieces_and_gathers_nothing(monkeypatch, arch):
    """On a fake (4, 4) mesh: no "gather" collective, the argument bytes
    of the gathered path, a busiest-device peak below it, FLOPs at most
    twice the gathered FLOPs over the 16 devices; and the class
    shortcut's record equal to the trace of every position's program
    (t_lower_s and n_ops aside, which count the work traced)."""
    _patch(monkeypatch)
    mesh = make_debug_mesh((4, 4), devices=dryrun.fake_devices(16))
    short = dryrun.run_cell(arch, "ogb_products", mesh=mesh, verbose=False)
    old, _ = dryrun.trace_cell(_gathered(
        specs.make_cell(arch, "ogb_products", mesh), arch))
    kinds = {part.split(":")[0] for part in short["collectives"].split()}
    assert "gather" not in kinds and "gather" in old.coll_by_op
    mem = short["bytes_per_device"]
    assert mem["argument"] == old.arg_bytes
    assert mem["peak_est"] < max(old.peak_bytes, old.arg_bytes
                                 + old.out_bytes - old.alias_bytes)
    assert short["roofline"]["flops/dev"] * 16 <= 2 * old.flops
    with C.every_position():
        full = dryrun.run_cell(arch, "ogb_products", mesh=mesh,
                               verbose=False)
    assert short["n_ops"] < full["n_ops"]
    for rec in (short, full):
        rec.pop("t_lower_s")
        rec.pop("n_ops")
    assert short == full


# ------------------------------------------------------------ the step


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_step_on_mesh_equals_reference(pna_run, kind, shape):
    """The partitioned loss and every position's copy of every leaf's
    gradient against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` and against the port's unpartitioned step."""
    _, tcfg = _configs(kind)
    ref_loss, ref = _reference_of(kind, pna_run)
    port_loss, port = _port(kind)
    with sh.use_mesh_rules(_mesh(shape)):
        loss, grads = GS.value_and_grad(tcfg, _model(kind), _batch(kind))
    assert abs(float(loss) - ref_loss) <= TOL * abs(ref_loss)
    assert abs(float(loss) - port_loss) <= TOL * abs(port_loss)
    assert grads.keys() == ref.keys()
    nan = {n for n, r in ref.items() if not np.isfinite(r).all()}
    assert nan == (PNA_REF_NAN if kind == "pna" else set())
    for n, r in ref.items():
        assert len(grads[n]) == 4
        for p, g in grads[n].items():
            g = g.numpy()
            assert np.isfinite(g).all(), (n, p)
            assert _rel(g, r) <= TOL, (n, p, _rel(g, r))
            assert _rel(g, port[n]) <= TOL, (n, p, _rel(g, port[n]))


def test_pna_tie_spans_positions():
    """The multigraph's parallel pair into node 61 lies in two edge
    slices of a four-way split, and the max and min aggregators tie
    there at a positive value in some channel of the first layer."""
    src, dst = (_batch("pna-no-std")[k] for k in ("edge_src", "edge_dst"))
    at = np.flatnonzero(dst == 61)
    assert len(at) == 2 and len(set(src[at])) == 1
    q = len(src) // 4
    assert at[0] // q != at[1] // q
    _, tcfg = _configs("pna-no-std")
    model = _model("pna-no-std")
    z = torch.relu(torch.as_tensor(_batch("pna-no-std")["feats"])
                   @ model.gnn.w_pre[0])
    assert (z[5] > 0).any()


def test_tie_split_gradient_equals_one_position_segment_max():
    """``reduce_scatter(op="max", counts=)`` over four positions' local
    maxima (``_TiedMax``), each position holding a quarter of the
    entries: the maximum and every entry's gradient equal, bit for bit,
    those of one ``segment_max`` over all the entries, with ties within
    and across positions."""
    rng = np.random.default_rng(3)
    n, m, F = 8, 64, 5
    ids = torch.as_tensor(rng.integers(0, n, m))
    vals = torch.as_tensor(rng.integers(0, 4, (m, F)).astype(np.float32))
    vals[ids == 7] = -1e30
    g = torch.as_tensor(rng.normal(size=(n, F)).astype(np.float32))
    whole = vals.clone().requires_grad_()
    ref = TL.segment_max(whole, ids, n)
    ref.backward(g)
    mesh = _mesh((2, 2))
    S = C.spmd(mesh, lambda p: (), False)
    axes = ("data", "model")
    part = vals.clone().requires_grad_()
    tops, ties = {}, {}
    for i, p in enumerate(S.run):
        sl = slice(16 * i, 16 * (i + 1))
        tops[p], ties[p] = GS._TiedMax.apply(part[sl], ids[sl], n)
    got = C.reduce_scatter(S, tops, axes, lambda q: (
        (2 * C.group_index(mesh, q, axes)[0],
         2 * C.group_index(mesh, q, axes)[0] + 2), (0, F)),
        dtype=torch.float32, op="max", counts=ties)
    out = torch.cat([got[p] for p in S.run])
    assert torch.equal(out, ref.detach())
    torch.autograd.backward([got[p] for p in S.run],
                            [g[2 * i:2 * i + 2] for i in range(4)])
    assert torch.equal(part.grad, whole.grad)
    across = [(ids[16 * i:16 * i + 16] == 3).any() for i in range(4)]
    assert sum(across) >= 2


def test_uneven_split_raises():
    """64 nodes over three positions, and a batch placed unevenly."""
    _, tcfg = _configs("gcn-cora")
    b = _batch("gcn-cora")
    with sh.use_mesh_rules(_mesh((1, 3))):
        with pytest.raises(ValueError, match="uneven"):
            GS.value_and_grad(tcfg, _model("gcn-cora"), b)
    mesh = _mesh((2, 2))
    cut = {k: v[:-2] if k == "edge_src" else v for k, v in b.items()}
    placed = {k: sh.place(torch.as_tensor(v), (("data", "model"),), mesh)
              if k != "n_grid" else v for k, v in cut.items()}
    with sh.use_mesh_rules(mesh):
        with pytest.raises(ValueError, match="uneven"):
            GS.loss_sharded(tcfg, _model("gcn-cora"), placed)


def test_update_over_pieces_equals_unpartitioned_update():
    """AdamW over the pieces (``update_placed``) on the reference's
    gradients equals the unpartitioned update on them."""
    _, tcfg = _configs("gat-cora")
    _, ref = _reference("gat-cora")
    opt = tadamw.AdamW(lr=1e-3)
    whole = _model("gat-cora")
    whole, _ = opt.update({n: torch.tensor(g) for n, g in ref.items()},
                          opt.init(whole), whole)
    mesh = _mesh((2, 2))
    with sh.use_mesh_rules(mesh):
        model = _model("gat-cora")
        params = place_params(model)
        grads = {n: {p: torch.tensor(ref[n]) for p in st.pieces}
                 for n, st in params.items()}
        params, state = opt.update_placed(grads, _placed_state(
            opt, model, mesh), params)
    want = dict(tadamw.named_leaves(whole))
    for n, st in params.items():
        for piece in st.pieces.values():
            assert torch.equal(piece, want[n]), n
    assert {int(t) for t in state.step.pieces.values()} == {1}
