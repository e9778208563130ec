"""The port's cells, op walk, roofline and dry run held against the JAX
reference on the CPU (``src/repro_torch/launch/specs.py``, ``hlo_walk``,
``hlo_analysis``, ``dryrun``, ``inspect_cell``), and the kernels' cost
functions and fake paths (``src/repro_torch/kernels/cost.py``).

The reference's cells exist only on a mesh of 256 or 512 devices, so
their metadata comes from one subprocess at 512 forced host devices,
started with the module's first test. ``make_cell`` must agree with it
on every cell at both production meshes: shape names, leaf paths,
shapes and dtypes, placements (one-axis entries normalised), whether
the outputs' placements are given, donation, rules and MODEL_FLOPS.
The one form difference, the unsharded SLING cell's graph (Â's layout
where the reference passes edge_src / edge_dst / w), is a cell that
``make_cell`` does not reach, as in the reference, and is checked on
its own through ``_sling_cell``.

The walk is held exactly on hand-made programs and, for dot FLOPs,
against the reference's ``hlo_walk.analyze`` of the same programs
compiled by XLA (whose elementwise FLOPs the port does not count).
"""
import dataclasses
import importlib
import json
import os
import re
import resource
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as rbase
from repro.launch import hlo_walk as rwalk
from repro.models import gnn as RG
from repro.optim.adamw import AdamW as RAdamW
from repro.train import steps as rsteps
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.kernels import cost as kcost
from repro_torch.kernels.cin import cin as kcin
from repro_torch.kernels.horner_push import ops as khp_ops
from repro_torch.kernels.spmv_ell import SpmmLayout
from repro_torch.kernels.spmv_ell import spmv_ell as kspmm
from repro_torch.launch import (dryrun, hlo_analysis, hlo_walk,
                                inspect_cell, specs)
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.train import steps as tsteps

# the wrappers' modules (each package re-exports a function of its name)
khp = importlib.import_module("repro_torch.kernels.horner_push.horner_push")
kjoin = importlib.import_module("repro_torch.kernels.hp_join.hp_join")

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": False, "2x16x16": True}
SHARDMAP = [("gcn-cora", s, "shardmap") for s in
            ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")]
CELLS = ([(a, s, "base") for a, s in dryrun.all_cells()] + SHARDMAP
         + [("sling-serve", "serve_batch", "base")])
# the dry run's cells here: the recsys path with the CIN kernel, its
# three gradient kernels, a GNN, and the recsys bulk batch
DRY_CELLS = [("xdeepfm", "serve_p99"), ("xdeepfm", "train_batch"),
             ("gcn-cora", "molecule"), ("xdeepfm", "serve_bulk")]
NEW_MODULES = ("launch/specs.py", "launch/dryrun.py", "launch/hlo_walk.py",
               "launch/hlo_analysis.py", "launch/inspect_cell.py",
               "kernels/cost.py")

REF_CELLS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = ["src"]
import numpy as np
import jax
from repro.launch import sharding as sh, specs
from repro.launch.mesh import make_production_mesh

CELLS = json.loads(sys.argv[2])

def spec(p):
    return [None if e is None else [e] if isinstance(e, str) else list(e)
            for e in p]

def placements(tree):
    return [[p, None if ns is None else spec(ns.spec)]
            for p, ns in sh.tree_paths(tree)]

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch, shape, variant in CELLS:
        c = specs.make_cell(arch, shape, mesh, variant=variant)
        nbytes = 0
        for arg, shard in zip(c.args, c.in_shardings):
            for (_, leaf), (_, ns) in zip(sh.tree_paths(arg),
                                          sh.tree_paths(shard)):
                nbytes += int(np.prod(ns.shard_shape(leaf.shape))
                              * np.dtype(leaf.dtype).itemsize)
        out[f"{arch}|{shape}|{variant}|{mp}"] = {
            "shape_name": c.shape_name,
            "leaves": [[[p, list(l.shape), str(l.dtype)]
                        for p, l in sh.tree_paths(a)] for a in c.args],
            "specs": [placements(s) for s in c.in_shardings],
            "out_none": c.out_shardings is None,
            "donate": list(c.donate_argnums),
            "rules": c.rules,
            "model_flops": c.model_flops,
            "arg_bytes": nbytes,
        }
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's subprocess, started when the module's first test
    runs; waited for by ``ref_cells``."""
    d = tmp_path_factory.mktemp("ref_cells")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_CELLS, str(d / "ref.json"),
         json.dumps(CELLS)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    yield d, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_cells(ref_run):
    d, proc = ref_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads((d / "ref.json").read_text())


def test_reference_started(ref_run):
    """Starts the reference's subprocess first, so that it runs beside
    the tests that need no reference."""
    assert ref_run[1].poll() in (None, 0)


def _spec(spec) -> list | None:
    return None if spec is None else [None if e is None else list(e)
                                      for e in spec]


def _fake_mesh(mp: bool):
    return make_production_mesh(multi_pod=mp, devices=dryrun.fake_devices(
        512 if mp else 256))


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _norm_rules(rules):
    return None if rules is None else json.loads(json.dumps(rules))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_cell_equals_reference(ref_cells, cell, mesh):
    """``make_cell``: the reference's shape name, leaves (paths in its
    order, shapes, dtypes), placements, donation, rules, MODEL_FLOPS and
    whether output placements are given, on both production meshes."""
    arch, shape, variant = cell
    mp = MESHES[mesh]
    ref = ref_cells[f"{arch}|{shape}|{variant}|{mp}"]
    c = specs.make_cell(arch, shape, _fake_mesh(mp), variant=variant)
    assert c.shape_name == ref["shape_name"]
    assert [[[p, list(t.shape), _dtype(t)] for p, t in tsh.tree_paths(a)]
            for a in c.args] == ref["leaves"]
    assert [[[p, _spec(None if ns is None else ns.spec)]
             for p, ns in s.items()] for s in c.in_shardings] == \
        [[[p, s] for p, s in arg] for arg in ref["specs"]]
    assert (c.out_shardings is None) == ref["out_none"]
    assert list(c.donate_argnums) == ref["donate"]
    assert _norm_rules(c.rules) == ref["rules"]
    assert c.model_flops == ref["model_flops"]
    assert all(isinstance(t, torch.Tensor) and kcost.is_fake(t)
               for a in c.args for _, t in tsh.tree_paths(a))


def test_unsharded_sling_cell_holds_a_layout():
    """The one form difference: ``sling_serve_step`` takes Â's layout,
    built fake on the mesh's first device, where the reference's cell
    passes edge_src / edge_dst / w; the index and batch match the pod
    cell's, and the step runs one push on the card's stand-in."""
    mesh = make_debug_mesh((2, 2), ("data", "model"),
                           devices=dryrun.fake_devices(4))
    with FakeTensorMode():
        c = specs._sling_cell(tbase.get("sling-serve"), "serve_batch", mesh,
                              None, "base")
    pod = specs.make_cell("sling-serve", "serve_batch", mesh)
    layout = c.args[1]["layout"]
    assert isinstance(layout, SpmmLayout) and kcost.is_fake(layout.in_ptr)
    assert layout.device == torch.device("meta", 0)
    cfg = tbase.get("sling-serve").full()
    assert layout.in_idx.shape == (specs._pad512(cfg.m),)
    assert layout.n == c.args[0]["keys"].shape[0] == specs._pad512(cfg.n)
    assert c.in_shardings[1] == {"layout": None}
    assert [(p, tuple(t.shape)) for p, t in tsh.tree_paths(c.args[0])] == \
        [(p, tuple(t.shape)) for p, t in tsh.tree_paths(pod.args[0])]
    walk, _ = dryrun.trace_cell(c)
    assert walk.kernels == {"horner_push_rows": 1}


# ----------------------------------------------------------------------
# the op walk
# ----------------------------------------------------------------------
def _fakes(*shapes, device="meta:0", dtype=torch.float32):
    with FakeTensorMode():
        return [torch.empty(s, dtype=dtype, device=device) for s in shapes]


def test_walk_matmul_chain_is_exact():
    """(a @ b) @ c: 2*M*K*N FLOPs a product, the operands and result of
    each product as its bytes, and the peak of live storage."""
    a, b, c = _fakes((64, 128), (128, 32), (32, 16))
    w = hlo_walk.analyze(lambda a, b, c: (a @ b) @ c, a, b, c)
    assert w.flops == 2 * 64 * 128 * 32 + 2 * 64 * 32 * 16
    assert w.hbm_bytes == 4 * ((64 * 128 + 128 * 32 + 64 * 32)
                               + (64 * 32 + 32 * 16 + 64 * 16))
    args = 4 * (64 * 128 + 128 * 32 + 32 * 16)
    assert w.arg_bytes == args and w.out_bytes == 4 * 64 * 16
    assert w.peak_bytes == args + 4 * (64 * 32 + 64 * 16)
    assert w.compute_s == pytest.approx(w.flops / kcost.FP32_OPS_PER_S)
    assert w.coll_bytes == 0 and w.kernels == {} and w.alias_bytes == 0
    assert [r.op for r in w.records] == ["mm", "mm"]


def test_walk_counts_every_iteration():
    """A Python loop of L products: eager dispatch visits each one, so
    the walk counts L times the body (no trip count to parse); bf16
    products are timed at the bf16 rate."""
    L = 7
    (x, m) = _fakes((32, 64), (64, 64), dtype=torch.bfloat16)

    def loop(x, m):
        for _ in range(L):
            x = x @ m
        return x

    w = hlo_walk.analyze(loop, x, m)
    assert w.flops == L * 2 * 32 * 64 * 64
    assert w.compute_s == pytest.approx(w.flops / kcost.BF16_OPS_PER_S)
    assert sum(r.op == "mm" for r in w.records) == L


def test_walk_skips_views():
    """Views and shape-only ops move no bytes; a contiguous copy does."""
    (x,) = _fakes((16, 32))

    def views(x):
        y = x.t().unsqueeze(0)[:, :8].view(1, 8, 16).expand(3, 8, 16)
        return y.contiguous()

    w = hlo_walk.analyze(views, x)
    assert w.flops == 0
    assert [r.op for r in w.records] == ["clone"]
    assert w.hbm_bytes == 4 * (3 * 8 * 16) * 2


def test_walk_copy_across_devices():
    """A copy between two fake devices: sent by one, received by the
    other, under the kind the code names (``collective``), "copy"
    otherwise; the busiest device's bytes are the totals."""
    (x,) = _fakes((256, 64))

    def move(x):
        with kcost.collective("all-gather"):
            y = x.to("meta:1")
        z = y.to("meta:2")
        return z.sum()

    w = hlo_walk.analyze(move, x)
    nb = 4 * 256 * 64
    d0, d1, d2 = (w.devices[f"meta:{i}"] for i in range(3))
    assert (d0.coll_sent, d0.coll_recv) == (nb, 0)
    assert (d1.coll_sent, d1.coll_recv) == (nb, nb)
    assert d1.coll_by_op == {"all-gather": nb} and d2.coll_by_op == {
        "copy": nb}
    assert w.coll_bytes == nb and w.coll_by_op == {"all-gather": nb,
                                                   "copy": nb}
    st = hlo_analysis.collective_stats(w.records, "meta:1")
    assert st.bytes_by_op == {"all-gather": nb} and st.count_by_op == {
        "all-gather": 1}


def test_walk_backward_and_peak():
    """A product's backward is walked too (two more products), and a
    storage freed mid-step leaves the peak where it was."""
    x, w_ = _fakes((32, 48), (48, 48))
    w_.requires_grad_(True)

    def step(x, w_):
        t = torch.relu(x @ w_)
        big = torch.empty((1024, 1024), device="meta:0")
        del big
        (t * t).sum().backward()
        return w_.grad

    w = hlo_walk.analyze(step, x, w_)
    assert w.flops == 2 * 32 * 48 * 48 * 2      # forward, dW (x needs none)
    assert w.devices["meta:0"].peak_bytes >= 4 * 1024 * 1024
    assert w.out_bytes == 4 * 48 * 48


_OP = re.compile(r"^(\s*(?:ROOT )?%[\w.\-]+ = .*?\s)([a-z][a-z0-9\-]*)\(")
_KEEP = {"dot", "while", "fusion", "call", "conditional", "constant",
         "parameter"}


def _ref_dot_flops(text: str) -> float:
    """The reference walk's FLOPs with its per-element count of every
    op but dot left out: each other op renamed to a shape-only bitcast,
    which its walk skips (shapes and trip counts stay)."""
    out = []
    for line in text.splitlines():
        m = _OP.match(line)
        if m and m.group(2) not in _KEEP:
            line = line[:m.start(2)] + "bitcast" + line[m.end(2):]
        out.append(line)
    return rwalk.analyze("\n".join(out)).flops


def test_walk_dot_flops_equal_reference_on_a_chain():
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=s).astype(np.float32)
               for s in ((64, 128), (128, 32), (32, 16)))
    txt = jax.jit(lambda a, b, c: (a @ b) @ c).lower(a, b, c).compile() \
        .as_text()
    got = hlo_walk.analyze(lambda *t: (t[0] @ t[1]) @ t[2],
                           *(torch.as_tensor(v) for v in (a, b, c)))
    assert got.flops == _ref_dot_flops(txt) == rwalk.analyze(txt).flops


def test_walk_dot_flops_equal_reference_on_gnn_train_step():
    """``gnn_train_step`` at ``gcn_cora.smoke()``: the same dot FLOPs as
    the reference's walk of its compiled step (forward and backward
    products); the reference's total adds a FLOP a result element of
    every other op, which the port does not count."""
    from test_torch_gnn import _batch, _graph
    r, t = rbase.get("gcn-cora").smoke(), tbase.get("gcn-cora").smoke()
    batch = _batch(r, _graph("ba"))
    params = RG.init_params(r, jr.PRNGKey(0))
    ropt = RAdamW(lr=1e-3)
    txt = jax.jit(rsteps.gnn_train_step(r, ropt)).lower(
        params, ropt.init(params), {k: jnp.asarray(v) for k, v in
                                    batch.items()}).compile().as_text()
    model = convert.gnn_params_from_jax(
        t, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    topt = TAdamW(lr=1e-3)
    got = hlo_walk.analyze(tsteps.gnn_train_step(t, topt), model,
                           topt.init(model),
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    dots = _ref_dot_flops(txt)
    assert got.flops == dots > 0
    assert rwalk.analyze(txt).flops > dots     # the elementwise count


# ----------------------------------------------------------------------
# the kernels' fakes and costs
# ----------------------------------------------------------------------
def _push_case(B=3, n=20, W=6, l_max=4, dev="cpu"):
    rng = np.random.default_rng(1)
    src = rng.integers(0, n, 60)
    dst = rng.integers(0, n, 60)
    lay = SpmmLayout.from_edges(src, dst, rng.uniform(size=60), n, dev)
    keys = torch.sort(torch.as_tensor(rng.integers(
        0, (l_max + 1) * n, (10, W)), dtype=torch.int32), dim=1).values
    vals = torch.as_tensor(rng.uniform(size=(10, W)), dtype=torch.float32)
    d = torch.as_tensor(rng.uniform(size=n), dtype=torch.float32)
    us = torch.as_tensor([1, 4, 7][:B], dtype=torch.int32)
    return keys, vals, d, us, lay


def _fake_like(mode, *ts, device="meta:0"):
    return [mode.from_tensor(t).to(device) for t in ts]


def _recorded(fn):
    got = []
    with kcost.listen(lambda *a: got.append(a)):
        out = fn()
    return out, got


def test_horner_fakes_match_plain():
    """Each push wrapper on fake tensors: the plain version's shapes and
    dtypes on the inputs' device, one recorded call at its cost (every
    slot live, every level run), nothing launched or counted."""
    keys, vals, d, us, lay = _push_case()
    plain = khp.horner_push_rows(keys, vals, d, us, lay, 0.01, l_max=4)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fk, fv, fd, fu = _fake_like(mode, keys, vals, d, us)
        flay = SpmmLayout(n=lay.n, **{f: mode.from_tensor(getattr(
            lay, f)).to("meta:0") for f in ("in_ptr", "in_idx", "w",
                                            "heavy", "light")})
        before = khp.horner_push_rows.launches
        out, got = _recorded(lambda: khp.horner_push_rows(
            fk, fv, fd, fu, flay, 0.01, l_max=4))
        assert khp.horner_push_rows.launches == before
    assert (tuple(out.shape), out.dtype) == (tuple(plain.shape), plain.dtype)
    assert out.device == torch.device("meta", 0)
    want = khp.horner_push_cost(3, 3 * 6, 60, 21, 20, 5, 4)
    assert got == [("horner_push_rows", want, torch.device("meta", 0))]
    # the slab wrapper: two slabs of one device, outs left as given
    with mode:
        slabs = [khp_ops.Slab(layout=SpmmLayout(
            n=10, in_ptr=torch.empty(11, dtype=torch.int32, device="meta:0"),
            in_idx=torch.empty(30, dtype=torch.int32, device="meta:0"),
            w=torch.empty(30, device="meta:0"),
            heavy=torch.empty(0, dtype=torch.int32, device="meta:0"),
            light=torch.empty(10, dtype=torch.int32, device="meta:0")),
            d=fd, start=10 * j, d_offset=0) for j in range(2)]
        outs = [torch.empty((10, 3), device="meta:0") for _ in slabs]
        res, got = _recorded(lambda: khp.horner_push_slabs(
            [(fk, fv, 0)], fu, slabs, outs, 0.01, n=20, l_max=4, hi=2,
            lo=1))
    assert res is None
    assert got == [("horner_push_slabs",
                    khp.horner_push_cost(3, 18, 60, 22, 20, 2, 4),
                    torch.device("meta", 0))]


def _cin_case():
    g = torch.Generator().manual_seed(2)
    x0 = torch.randn((5, 4, 3), generator=g)
    xk = torch.randn((5, 6, 3), generator=g)
    W = torch.randn((7, 6, 4), generator=g)
    gr = torch.randn((5, 7, 3), generator=g)
    return x0, xk, W, gr


@pytest.mark.parametrize("name", ["cin_layer", "cin_grad_xk", "cin_grad_x0",
                                  "cin_grad_w"])
def test_cin_fakes_match_plain(name):
    x0, xk, W, gr = _cin_case()
    args = (x0, xk, W) if name == "cin_layer" else (x0, xk, W, gr)
    fn = getattr(kcin, name)
    plain = fn(*args)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fargs = _fake_like(mode, *args)
        out, got = _recorded(lambda: fn(*fargs))
    assert (tuple(out.shape), out.dtype) == (tuple(plain.shape), plain.dtype)
    assert out.device == torch.device("meta", 0)
    want = kcin.cin_layer_cost(*args) if name == "cin_layer" else \
        kcin.cin_grad_cost(*args, plain)
    assert got == [(name, want, torch.device("meta", 0))]
    assert want.passes == 3 and want.rate == kcost.TF32_OPS_PER_S


def test_cin_layer_autograd_on_fakes_records_each_gradient():
    """Through ``CinLayer`` under autograd: one forward and, at a layer
    whose xk is x0 itself, the three gradient kernels once each."""
    x0, _, W, _ = _cin_case()
    W = W[:, :4].contiguous()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fx, fw = _fake_like(mode, x0, W)
        fx.requires_grad_(True)
        fw.requires_grad_(True)
        _, got = _recorded(lambda: kcin.cin_layer(fx, fx, fw).sum()
                           .backward())
    assert sorted(g[0] for g in got) == ["cin_grad_w", "cin_grad_x0",
                                         "cin_grad_xk", "cin_layer"]


def test_real_tensors_never_reach_fakes():
    """CPU tensors take the plain versions and record nothing."""
    keys, vals, d, us, lay = _push_case()
    x0, xk, W, gr = _cin_case()
    _, got = _recorded(lambda: (
        khp.horner_push_rows(keys, vals, d, us, lay, 0.01, l_max=4),
        kcin.cin_layer(x0, xk, W), kcin.cin_grad_xk(x0, xk, W, gr),
        kcin.cin_grad_x0(x0, xk, W, gr), kcin.cin_grad_w(x0, xk, W, gr)))
    assert got == []
    assert not kcost.is_fake(keys, x0)


def _cin_serve_cost():
    """The three CIN layers of a serve_p99 batch: B = 512, m = 39,
    D = 10, 39-200-200-200."""
    x0 = torch.empty((512, 39, 10), device="meta")
    xk = torch.empty((512, 200, 10), device="meta")
    Ws = [torch.empty((200, 39, 39), device="meta")] + \
        [torch.empty((200, 200, 39), device="meta")] * 2
    return kcost.total(kcin.cin_layer_cost(x0, x0 if i == 0 else xk, W)
                       for i, W in enumerate(Ws))


# PERF.md §6's Bound column, each row's cost function at the row's
# inputs; the data-dependent counts (live entries, levels that run,
# live segments) are the ones phase 4 prints ("cost inputs"), read on
# an NVIDIA H100 80GB HBM3 at 700.00 W
PERF_BOUNDS = {
    "hp_join": (lambda: kjoin.hp_join_cost(256, 74662, 73064, 832),
                "0.00035", "bytes"),
    "horner_push_rows": (lambda: khp.horner_push_cost(
        8, 2424, 146712, 36693, 36692, 13, 8), "0.00075", "bytes"),
    "horner_push_slabs": (lambda: khp.horner_push_cost(
        8, 2424, 146712, 36692 + 4, 36692, 13, 8), "0.00075", "bytes"),
    "sling-serve": (lambda: khp.horner_push_cost(
        1024, 1027, 5270035, 1000001, 1000000, 2, 8), "1.2365", "bytes"),
    "spmm": (lambda: kspmm.spmm_cost(36692, 256, 146712, 131121, 564442,
                                     36692), "0.0167", "bytes"),
    "cin": (_cin_serve_cost, "0.2126", "operations"),
}


@pytest.mark.parametrize("row", list(PERF_BOUNDS))
def test_cost_functions_give_the_perf_bounds(row):
    fn, shown, by = PERF_BOUNDS[row]
    ms, got_by = fn().bound_ms()
    assert f"{ms:.{len(shown) - 2}f}" == shown and got_by == by


def test_cost_functions_count_as_documented():
    """The push, the join and Â's costs by their formulas."""
    c = khp.horner_push_cost(8, 100, 1000, 501, 500, 3, 8)
    assert (c.bytes, c.flops) == (64 + 1200 + 8000 + 2004 + 16000,
                                  2 * 3 * 1000 * 8)
    j = kjoin.hp_join_cost(256, 1000, 900, 832)
    assert j.bytes == 8 * 1900 + 12 * 256
    assert j.flops == pytest.approx(2 * 1000 * (np.log2(832) + 1))
    dense = kspmm.spmm_cost(100, 64, 300)
    assert (dense.bytes, dense.flops) == (8 * 100 * 64 + 2400 + 404,
                                          2 * 300 * 64)
    masked = kspmm.spmm_cost(100, 64, 300, 50, 120, 100)
    assert (masked.bytes, masked.flops) == (
        128 * 50 + 4 * 100 * 64 + 2400 + 404 + 800, 64 * 120)


# ----------------------------------------------------------------------
# the dry run
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def dry_records():
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    recs = {(a, s, m): dryrun.run_cell(a, s, multi_pod=mp, verbose=False)
            for a, s in DRY_CELLS for m, mp in MESHES.items()}
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) \
        * 1024
    return recs, grown


REF_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "t_lower_s",
            "t_compile_s", "model_flops", "bytes_per_device", "roofline",
            "collectives"}
BYTE_KEYS = {"argument", "output", "temp", "alias", "peak_est"}
ROW_KEYS = {"flops/dev", "hbm_bytes/dev", "coll_bytes/dev", "t_compute_s",
            "t_memory_s", "t_collective_s", "bottleneck", "useful_ratio",
            "roofline_mfu", "arg_bytes/dev", "temp_bytes/dev"}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", DRY_CELLS, ids=lambda c: "-".join(c))
def test_dry_run_record(dry_records, ref_cells, cell, mesh):
    """``run_cell``: the reference's keys, no compile, per-device argument
    bytes equal to the reference's shard sizes, a positive useful ratio
    (the port runs the recsys steps on one device after a gather, so the
    busiest device does all of their FLOPs; the GNN's partitioned step
    reads its pieces and gathers nothing), the port kernels on the path,
    and less than 1 GB of host memory for all of them."""
    recs, grown = dry_records
    rec = recs[(*cell, mesh)]
    ref = ref_cells[f"{cell[0]}|{cell[1]}|base|{MESHES[mesh]}"]
    assert REF_KEYS <= set(rec) and rec["ok"] and rec["mesh"] == mesh
    assert set(rec["bytes_per_device"]) == BYTE_KEYS
    assert set(rec["roofline"]) == ROW_KEYS
    assert rec["t_compile_s"] == 0.0
    assert rec["bytes_per_device"]["argument"] == ref["arg_bytes"]
    assert rec["model_flops"] == ref["model_flops"]
    r = rec["roofline"]
    assert r["useful_ratio"] > 0 and r["roofline_mfu"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    gathered = re.search(r"(^| )gather:", rec["collectives"]) is not None
    assert gathered == (cell[0] == "xdeepfm")
    want = {"serve_p99": {"cin_layer": 3}, "serve_bulk": {"cin_layer": 3},
            "train_batch": {"cin_layer": 3, "cin_grad_xk": 3,
                            "cin_grad_x0": 3, "cin_grad_w": 3},
            "molecule": {}}[cell[1]]
    assert rec["kernels"] == want
    if cell[0] == "gcn-cora":
        # message passing: gnn_model_flops counts 2*m*d a layer that no
        # product does, so the model's FLOPs pass the walked products
        assert rec["model_flops"] > r["flops/dev"]
    assert grown < 1 << 30


def test_shardmap_gcn_all_gathers_equal_analytic():
    """The shardmap GCN reads its batch piece by piece (no gather) and
    exchanges h once a layer: each device receives every other shard's
    rows of each layer's output, (NS - 1) * n_l * width * 4 bytes. On a
    2 x 4 mesh of fake devices (at 16 x 16 the same walk makes 2 x 256^2
    copies)."""
    mesh = make_debug_mesh((2, 4), ("data", "model"),
                           devices=dryrun.fake_devices(8))
    c = specs.make_cell("gcn-cora", "ogb_products", mesh,
                        variant="shardmap")
    cfg = dataclasses.replace(tbase.get("gcn-cora").full(), d_in=100)
    n_l = c.args[2]["feats"].shape[0] // 8
    widths = [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    want = sum(7 * n_l * w * 4 for w in widths)
    walk, _ = dryrun.trace_cell(c)
    assert walk.coll_by_op["all-gather"] == want
    assert [d.coll_by_op.get("all-gather") for name, d in
            walk.devices.items() if name.startswith("meta")] == [want] * 8
    assert not re.search(r"(^| )gather:", hlo_analysis.collective_stats(
        walk.records).summary())
    assert walk.arg_bytes > 0


def test_jitted_checks_placements():
    """A leaf placed otherwise than the cell says is refused."""
    mesh = make_debug_mesh((2, 2), ("data", "model"),
                           devices=dryrun.fake_devices(4))
    c = specs.make_cell("xdeepfm", "serve_p99", mesh)
    mode = FakeTensorMode()
    with mode:
        placed = c.place(c.args)
    p = placed[1]
    wrong = dict(p.leaves)
    wrong["ids"] = tsh.ShardedTensor(tsh.NamedSharding(mesh, ()),
                                     wrong["ids"].shape, wrong["ids"].pieces)
    with pytest.raises(ValueError, match="ids"):
        c.jitted()(placed[0], specs.Placed(p.template, wrong))


def test_dryrun_and_inspect_cli(tmp_path, capsys):
    """The dry run's CLI as the README runs it, and the inspector's
    walk line and top tensors."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "rec.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "xdeepfm", "--shape", "serve_p99",
                        "--out", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert len(rec) == 1 and rec[0]["ok"] and "1/1 cells traced OK" in \
        r.stdout
    _, walk = inspect_cell.inspect("xdeepfm", "serve_p99", top=5)
    printed = capsys.readouterr().out
    assert re.search(r"^walk: flops [0-9.e+]+ hbm [0-9.e+]+ coll", printed,
                     re.M)
    assert "cin_layer" in printed and walk.kernels == {"cin_layer": 3}
    assert len(printed.split("counted) ---")[1].strip().splitlines()) == 5


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_reference(module):
    src = (ROOT / "src" / "repro_torch" / module).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import repro\b|"
                         r"from repro\b(?!_torch))", src, re.M)


def test_push_workspace_cache_keeps_no_fake_buffer():
    """A dry run's push takes a fresh fake workspace and leaves the
    thread's cache of real buffers as it was, so a later real push never
    reads a fake one."""
    from repro_torch.core import single_source as ss
    real = ss._workspace(torch.device("cpu"), 4, 10, 2)
    with FakeTensorMode():
        fake = ss._workspace(torch.device("cpu"), 4, 10, 2)
        assert kcost.is_fake(fake) and fake is not real
    assert ss._workspace(torch.device("cpu"), 4, 10, 2) is real


def test_walk_gathers_and_scatters_move_their_rows():
    """A row gather moves its indices and the rows it reads, not the
    whole table; an in-place scatter its indices and values (read, and
    the rows they land on read and written)."""
    tab, vals = _fakes((100_000, 16), (32, 16))
    with detect_fake_mode([tab]):
        idx = torch.zeros(32, dtype=torch.int64, device="meta:0")

    def rows(t, i, v):
        got = t.index_select(0, i)
        t.index_add_(0, i, v)
        return got

    w = hlo_walk.analyze(rows, tab, idx, vals)
    nb = 4 * 32 * 16
    assert w.hbm_bytes == (8 * 32 + 2 * nb) + (8 * 32 + 3 * nb)


@pytest.mark.parametrize("name", ["split_weights", "split_weights_x0",
                                  "split_grad_t", "split_grad_rows"])
def test_cin_prepass_fakes_match_plain(name):
    """The pre-passes' card paths on fake tensors: the plain version's
    shape and dtype, on the input's device, nothing recorded (their
    work is inside their wrapper's cost)."""
    _, _, W, gr = _cin_case()
    src = W if name.startswith("split_weights") else gr
    plain = getattr(kcin, name)(src)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        (fsrc,) = _fake_like(mode, src)
        out, got = _recorded(lambda: getattr(kcin, name + "_on_card")(fsrc))
    assert (tuple(out.shape), out.dtype, got) == (tuple(plain.shape),
                                                 plain.dtype, [])
    assert out.device == torch.device("meta", 0)
