"""The port's sharding rules, sharded models and reshard-on-restore held
against the JAX reference on the CPU.

* ``launch/sharding.py``: the four cases of ``tests/test_sharding.py``;
  ``tree_specs`` of every registered architecture's ``full()``
  parameters against the reference's, path by path, on the production
  shapes (16, 16) and (2, 16, 16) and on (2, 2) and (4, 1) (the port's
  parameters under ``FakeTensorMode``, the reference's from
  ``jax.eval_shape``: mixtral's 141 B float32 parameters are never
  allocated); each placement's per-position index slices against
  ``NamedSharding.devices_indices_map``; ``place`` and ``gather``.
* ``moe_ffn``'s mesh branch against the reference's ``shard_map``
  branch (G = 2 and 4 with a capacity that binds in one shard, T % G
  != 0, a smoke MoE LM's ``lm_loss`` under ``use_mesh_rules``),
  forward and gradients within TOL of max |ref|.
* ``gcn_loss_sharded`` against the reference's on the oracle zoo and
  BA(150) at NS = 2 and 4; ``build_sharded_gcn_batch``'s arrays equal
  the reference's bit for bit; the sharded train step against the
  unsharded ``gnn.loss_fn``, and an elastic resume (save on four
  shards, restore on the two that ``remesh`` plans).
* ``restore(mesh=, shardings=, opt_shardings=)``: each package restores
  the other's file under two meshes with equal arrays and the same
  slices per position.
* the two kernel oracles ``join_ref`` and ``spmm_ref``.

The reference's mesh answers come from one subprocess that forces
host devices (512, so that ``make_production_mesh`` builds as well; its
meshes take the first 1, 2 or 4), started when the module's first test
runs and read by the tests that need it. Mesh positions run row-major;
the port's meshes repeat the CPU device.
"""
import ast
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
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

import oracle
from repro.configs import base as rbase
from repro.graph import generators as rgen
from repro.kernels.hp_join import ref as rjoin_ref
from repro.kernels.spmv_ell import ref as rspmm_ref
from repro.launch import sharding as rsh
from repro.models import gnn as RG
from repro.models import gnn_sharded as RGS
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro_torch.configs import base as tbase
from repro_torch.graph import generators as tgen
from repro_torch.kernels.hp_join.ref import PAD, join_ref
from repro_torch.kernels.spmv_ell.ref import spmm_ref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import gnn as TG
from repro_torch.models import gnn_sharded as TGS
from repro_torch.models import moe as TM
from repro_torch.models import recsys as TR
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamW, AdamWState, named_leaves
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as telastic
from repro_torch.train.trainer import value_and_grad
from torch_cases import JOIN_CASES, join_rows

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5          # of max |ref|: float32 reduction order
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "2x2": (2, 2),
          "4x1": (4, 1)}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
GRAPHS = ("er", "powerlaw", "dag", "sinks", "multigraph", "ba150")
MOE_CASES = {"G2": (2, 48), "G4": (4, 48), "uneven": (4, 42)}
MOE_K, MOE_CF = 2, 1.5
NEW_MODULES = ("launch/sharding.py", "launch/mesh.py", "models/moe.py",
               "models/gnn_sharded.py", "train/checkpoint.py",
               "kernels/hp_join/ref.py", "kernels/spmv_ell/ref.py")

REF_MESH = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = ["src", "tests"]
import numpy as np
import jax, jax.numpy as jnp, jax.random as jr
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import oracle
from repro.configs import base as rbase
from repro.graph import generators as rgen
from repro.launch import sharding as sh
from repro.launch.mesh import make_production_mesh
from repro.models import gnn as RG, moe as RM, transformer as RT
from repro.models.gnn_sharded import build_sharded_gcn_batch, gcn_loss_sharded
from repro.optim.adamw import AdamWState
from repro.train import checkpoint as rckpt

out = {}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out[f"prod/{mp}/shape"] = np.asarray(list(m.shape.values()))
    out[f"prod/{mp}/axes"] = np.asarray(m.axis_names)
DEVS = jax.devices()[:4]

def mesh(shape, axes):
    return Mesh(np.asarray(DEVS[:int(np.prod(shape))],
                           dtype=object).reshape(shape), axes)

def names(tree):
    n, l, _ = rckpt._flatten(tree)
    return dict(zip(n, l))

def slices(index, shape):
    return [sl.indices(n)[:2] for sl, n in zip(index, shape)]

# ---- the MoE layer's shard_map branch
rng = np.random.default_rng(7)
T, d, f, E = 48, 12, 20, 4
x = rng.normal(size=(T, d)).astype(np.float32)
router = rng.normal(size=(d, E)).astype(np.float32)
x[:T // 4] += 3.0 * router[:, 0] / np.linalg.norm(router[:, 0])
wg, wu = (rng.normal(size=(E, d, f)).astype(np.float32) * 0.3
          for _ in range(2))
wd = rng.normal(size=(E, f, d)).astype(np.float32) * 0.3
ct = rng.normal(size=(T, d)).astype(np.float32)
for k, v in dict(x=x, router=router, wg=wg, wu=wu, wd=wd, ct=ct).items():
    out[f"moe/in/{k}"] = v
for G, TT in %(moe)r:
    mh = mesh((G, 1), ("data", "model"))
    def fn(*a):
        y, aux = RM.moe_ffn(*a, %(k)d, %(cf)r)
        return jnp.sum(y * ct[:TT]) + 3.0 * aux, (y, aux)
    with mh, sh.use_mesh_rules(mh):
        (_, (y, aux)), gr = jax.jit(jax.value_and_grad(
            fn, argnums=tuple(range(5)), has_aux=True))(
            x[:TT], router, wg, wu, wd)
    out[f"moe/{G}/{TT}/y"], out[f"moe/{G}/{TT}/aux"] = y, aux
    for nm, g in zip(("x", "router", "w_gate", "w_up", "w_down"), gr):
        out[f"moe/{G}/{TT}/g/{nm}"] = g

# ---- a smoke MoE LM's lm_loss under use_mesh_rules on (2, 2)
cfg = dataclasses.replace(rbase.get("mixtral-8x22b").smoke(),
                          dtype=jnp.float32, capacity_factor=%(cf)r)
params = RT.init_params(cfg, jr.PRNGKey(0))
blocks = dict(params["blocks"])     # tests/test_torch_lm.py's _conditioned
for nm, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                  ("wv", cfg.n_kv_heads)):
    blocks[nm] = blocks[nm] * np.float32(np.sqrt(heads / cfg.d_model))
params = {**params, "blocks": blocks}
toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
tgts = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
out["lm/tokens"], out["lm/targets"] = toks, tgts
for k, v in names(params).items():
    out[f"lm/p/{k}"] = v
m22 = mesh((2, 2), ("data", "model"))
with m22, sh.use_mesh_rules(m22):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(cfg, p, toks, tgts)))(params)
out["lm/loss"] = loss
for k, v in names(grads).items():
    out[f"lm/g/{k}"] = v

# ---- the index slices of the smoke LM's leaves on (2, 2)
leaves = names(params)
for k, s in names(sh.tree_shardings(params, m22)).items():
    dm = s.devices_indices_map(leaves[k].shape)
    out[f"map/{k}"] = np.asarray(
        [slices(dm[m22.devices[p]], leaves[k].shape)
         for p in np.ndindex(*m22.devices.shape)], np.int64)

# ---- the sharded GCN on the zoo and BA(150)
gcfg = rbase.get("gcn-cora").smoke()
gp = RG.init_params(gcfg, jr.PRNGKey(3))
for k, v in names(gp).items():
    out[f"gcn/p/{k}"] = v
graphs = dict(oracle.cases(),
              ba150=rgen.barabasi_albert(150, 3, seed=2, directed=False))
for name, g in graphs.items():
    for NS in (2, 4):
        b = build_sharded_gcn_batch(g, gcfg.d_in, gcfg.n_classes, NS, seed=1)
        with sh.use_mesh_rules(mesh((NS,), ("data",))):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: gcn_loss_sharded(gcfg, p, b)))(gp, b)
        out[f"gcn/{name}/{NS}/loss"] = loss
        for k, v in names(grads).items():
            out[f"gcn/{name}/{NS}/g/{k}"] = v

# ---- checkpoints restored under a new mesh: this package's, the port's
ost = AdamWState(
    step=jnp.int32(7),
    m=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                         jnp.float32), params),
    v=jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape),
                                         jnp.float32), params))
m41 = mesh((4, 1), ("data", "model"))
rckpt.save(sys.argv[2], 2, jax.device_put(params, sh.tree_shardings(
    params, m41)), ost, extra={"mesh": [4, 1]})
for tag, path in (("ref", sys.argv[2]), ("port", sys.argv[3])):
    for mtag, shape in %(ck)r:
        mb = mesh(shape, ("data", "model"))
        ps = sh.tree_shardings(params, mb)
        os_ = AdamWState(step=NamedSharding(mb, P()), m=ps, v=ps)
        rp, ro, _ = rckpt.restore(path, 2, params, ost, mb, ps, os_)
        got = {**{f"p/{n}": v for n, v in names(rp).items()},
               **{f"o/{n}": v for n, v in names(ro).items()}}
        for k, a in got.items():
            key = f"ck/{tag}/{mtag}/{k}"
            by_dev = {s.device: s for s in a.addressable_shards}
            at = [by_dev[mb.devices[p]] for p in np.ndindex(*shape)]
            out[key + "/whole"] = a
            out[key + "/idx"] = np.asarray(
                [slices(s.index, a.shape) for s in at],
                np.int64).reshape(len(at), a.ndim, 2)
            out[key + "/data"] = np.stack([np.asarray(s.data) for s in at])
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
print("REF_MESH_OK")
"""
CK_MESHES = (("22", (2, 2)), ("14", (1, 4)))


def _cpu_mesh(shape, axes=None):
    shape = tuple(shape)
    axes = axes or AXES.get(len(shape), ("data",))
    return tmesh.make_debug_mesh(shape, axes,
                                 devices=["cpu"] * int(np.prod(shape)))


def _spec(p) -> tuple:
    """``tuple()`` of a reference ``PartitionSpec``, each entry a tuple
    of axes or None: this JAX stores a one-axis tuple as its name."""
    return tuple((e,) if isinstance(e, str) else e for e in p)


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(float(np.abs(ref).max()), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _fill(model, ref: dict, prefix: str):
    """``model``'s leaves set to the reference's arrays ``prefix/<name>``."""
    with torch.no_grad():
        for n, p in named_leaves(model):
            p.copy_(torch.from_numpy(np.asarray(ref[f"{prefix}/{n}"])))
    return model


def _lm_cfg():
    return dataclasses.replace(tbase.get("mixtral-8x22b").smoke(),
                               dtype=torch.float32, capacity_factor=MOE_CF)


def _port_ckpt_state():
    """The port's smoke LM (seed 5) and an AdamW state with random m and
    v: the file the reference restores."""
    cfg = _lm_cfg()
    model = TT.init_params(cfg, torch.Generator().manual_seed(5))
    state = AdamW().init(model)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for t in [*state.m.values(), *state.v.values()]:
            t.copy_(torch.rand(t.shape, generator=gen))
    return model, AdamWState(step=torch.tensor(9, dtype=torch.int32),
                             m=state.m, v=state.v)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's subprocess, started (after the port writes its
    checkpoint) when the module's first test runs; waited for by
    ``ref_mesh``."""
    d = tmp_path_factory.mktemp("ref_mesh")
    model, state = _port_ckpt_state()
    tckpt.save(str(d / "port_ckpt"), 2, model, state)
    code = REF_MESH % {"moe": tuple(MOE_CASES.values()), "k": MOE_K,
                       "cf": MOE_CF, "ck": CK_MESHES}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(d / "ref.npz"),
         str(d / "ref_ckpt"), str(d / "port_ckpt")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    yield d, proc, model, state
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _start_reference(ref_run):
    """Start the reference's subprocess with the module's first test."""


@pytest.fixture(scope="module")
def ref_mesh(ref_run):
    d, proc, model, state = ref_run
    out, err = proc.communicate(timeout=300)
    assert "REF_MESH_OK" in out, out + err
    with np.load(d / "ref.npz") as z:
        return {"dir": d, "model": model, "state": state, **dict(z)}


# ----------------------------------------------------------- the rules


class _FakeMesh:
    """A mesh-like object with only ``.shape``, as tests/test_sharding.py
    gives both packages' rule functions (they read nothing else)."""

    def __init__(self, sizes):
        self.shape = sizes


@pytest.fixture
def rules_ctx():
    """Both packages' rule context on a (4, 2) fake mesh."""
    mesh = _FakeMesh({"data": 4, "model": 2})
    rsh._CTX["mesh"], rsh._CTX["rules"] = mesh, dict(rsh.DEFAULT_RULES)
    try:
        with tsh.use_mesh_rules(mesh):
            yield mesh
    finally:
        rsh._CTX["mesh"], rsh._CTX["rules"] = None, None


def test_spec_divisibility_fallback(rules_ctx):
    mesh = rules_ctx
    cases = [(((16, 8, 8), ("batch", "heads", "head_dim"), False),
              (("data",), ("model",), None)),
             (((16, 3, 8), ("batch", "heads", "head_dim"), False),
              (("data",), None, ("model",))),
             (((16, 5, 3), ("batch", "heads", "head_dim"), True),
              (("data",), ("model",), None)),
             (((16, 5, 3), ("batch", "heads", "head_dim"), False),
              (("data",), None, None))]
    for (shape, names, uneven), want in cases:
        got = tsh.spec_for(shape, names, mesh, allow_uneven=uneven)
        assert got == want
        assert got == _spec(rsh.spec_for(shape, names, mesh,
                                         allow_uneven=uneven))


def test_axis_used_once(rules_ctx):
    spec = tsh.spec_for((8, 4, 2), ("dff", "vocab", "experts"), rules_ctx)
    used = [a for p in spec if p for a in p]
    assert len(used) == len(set(used))
    assert spec == _spec(rsh.spec_for((8, 4, 2), ("dff", "vocab", "experts"),
                                      rules_ctx))


def test_param_rules_match_paths(rules_ctx):
    mesh = rules_ctx
    assert tsh.param_spec("embed", (1024, 64), mesh) == (("model",),
                                                         ("data",))
    assert tsh.param_spec("tables/embed", (4, 1024, 8), mesh) == \
        (None, ("model",), None)
    assert tsh.param_spec("embed", (10,), mesh) == ()     # rank mismatch
    for path, shape in (("embed", (1024, 64)), ("tables/embed", (4, 1024, 8)),
                        ("embed", (10,)), ("gnn/w/0", (16, 8)),
                        ("blocks/moe_w_gate", (2, 4, 64, 128)),
                        ("recsys/cin_w/0", (3, 4, 5)), ("nothing", (4,))):
        assert tsh.param_spec(path, shape, mesh) == \
            _spec(rsh.param_spec(path, shape, mesh)), path


def test_logical_noop_without_mesh_and_resolves_under_one(rules_ctx):
    x = torch.ones((4, 4))
    with tsh.use_mesh_rules(None):
        assert tsh.logical(x, "batch", "vocab") is x
        assert tsh.spec_for((4, 4), ("batch", "vocab")) == ()
        assert tsh.active_mesh() is None and tsh.data_group_count() == 1
    assert tsh.logical(x, "batch", "vocab") is x
    with pytest.raises(ValueError):
        tsh.logical(x, "batch")
    with pytest.raises(AssertionError):
        rsh.spec_for((4, 4), ("batch",), rules_ctx)
    assert tsh.data_group_count() == rsh.data_group_count() == 4
    assert tsh.active_mesh() is rules_ctx


def test_use_mesh_rules_merges_and_restores():
    mesh = _FakeMesh({"data": 2, "model": 2})
    with tsh.use_mesh_rules(mesh, {"kv_seq": [("model",)]}):
        assert tsh.spec_for((4, 8), ("batch", "kv_seq")) == (("data",),
                                                             ("model",))
        with tsh.use_mesh_rules(_FakeMesh({"pod": 2, "data": 3})):
            assert tsh.data_group_count() == 6
            assert tsh.spec_for((4, 8), ("batch", "kv_seq")) == (None, None)
        assert tsh.active_mesh() is mesh
    assert tsh.active_mesh() is None


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """([(path, shape)], the shape tree) of the reference's ``full()``
    parameters, from ``jax.eval_shape``."""
    cfg = rbase.get(arch).full()
    init = {"lm": RT.init_params, "gnn": RG.init_params,
            "recsys": RR.init_params}[rbase.get(arch).family]
    tree = jax.eval_shape(lambda: init(cfg, jr.PRNGKey(0)))
    return [(p, tuple(l.shape)) for p, l in rsh.tree_paths(tree)], tree


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    """The port's ``full()`` parameters as a module of fake tensors (no
    memory)."""
    cfg = tbase.get(arch).full()
    init = {"lm": TT.LMParams, "gnn": TG.GNNParams,
            "recsys": TR.XDeepFM}[tbase.get(arch).family]
    with FakeTensorMode():
        model = init(cfg, torch.Generator().manual_seed(0))
    return model


MODEL_ARCHS = [a for a, s in sorted(rbase.all_archs().items())
               if s.family != "sling"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_tree_specs_equal_reference(arch, mesh):
    """``tree_specs`` of the full config's parameters: the same paths in
    the same order and, leaf by leaf, ``tuple()`` of the reference's
    spec. The port's mesh is real (repeated CPU devices), the
    reference's a shape-only stand-in, which is all its rules read."""
    shape = MESHES[mesh]
    ref_leaves, tree = _ref_leaves(arch)
    ref = rsh.tree_specs(tree, _FakeMesh(dict(zip(AXES[len(shape)],
                                                  shape))))
    ref_specs = [_spec(s) for s in jax.tree.leaves(
        ref, is_leaf=lambda x: isinstance(x, P))]
    model = _port_model(arch)
    got = tsh.tree_specs(model, _cpu_mesh(shape))
    assert [(p, s) for p, s in ref_leaves] == \
        [(p, tuple(t.shape)) for p, t in tsh.tree_paths(model)]
    assert list(got) == [p for p, _ in ref_leaves]
    assert list(got.values()) == ref_specs
    if len(shape) == 3 and tbase.get(arch).family == "lm":
        assert any(s and ("pod", "data") in s for s in ref_specs)


def test_production_mesh_equals_reference(ref_mesh):
    """``make_production_mesh``'s shape and axes against the
    reference's function (in the subprocess, 512 forced devices); over
    repeated devices here, and without enough CUDA devices it raises."""
    for mp in (False, True):
        m = tmesh.make_production_mesh(
            multi_pod=mp, devices=["cpu"] * (512 if mp else 256))
        assert list(m.shape.values()) == ref_mesh[f"prod/{mp}/shape"].tolist()
        assert m.axis_names == tuple(ref_mesh[f"prod/{mp}/axes"].tolist())
    if torch.cuda.device_count() < 256:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            tmesh.make_production_mesh()


def test_mesh_positions_run_row_major():
    m = _cpu_mesh((2, 3, 2))
    pos = m.axes_positions(("pod", "data"))
    assert pos == [(p, d, 0) for p in range(2) for d in range(3)]
    assert m.axes_positions(("data",), model=1) == [(0, 0, 1), (0, 1, 1),
                                                   (0, 2, 1)]
    assert m.axes_positions(()) == [(0, 0, 0)]
    assert len(m.axes_devices(("pod", "data", "model"))) == 12
    with pytest.raises(ValueError):
        m.axes_positions(("nope",))


def test_index_slices_equal_reference_devices_indices_map(ref_mesh):
    """Every smoke-LM leaf's placement on (2, 2): the index slices of
    each mesh position equal the reference's ``devices_indices_map``;
    the pieces hold those slices and gather back to equal bits."""
    model = _fill(TT.LMParams(_lm_cfg(), device="cpu"), ref_mesh, "lm/p")
    mesh = _cpu_mesh((2, 2))
    shards = tsh.tree_shardings(model, mesh)
    cut = 0
    for n, t in named_leaves(model):
        want = ref_mesh[f"map/{n}"]
        got = shards[n].devices_indices_map(t.shape)
        assert list(got) == list(np.ndindex(2, 2))
        got_idx = np.asarray([[(s.start, s.stop) for s in sl]
                              for sl in got.values()], np.int64)
        np.testing.assert_array_equal(got_idx.reshape(want.shape), want,
                                      err_msg=n)
        placed = shards[n].shard(t.detach())
        for pos, sl in got.items():
            assert torch.equal(placed.pieces[pos], t.detach()[sl])
        assert torch.equal(placed.gather(), t.detach())
        cut += len({tuple(map(tuple, r)) for r in want}) == 4
    assert cut >= 3      # leaves really cut over both axes


def test_place_keeps_the_sling_form_and_cuts_uneven_like_tensor_split():
    mesh = _cpu_mesh((3, 2))
    x = torch.arange(7 * 4).reshape(7, 4)
    parts = tsh.place(x, ("data", 0), mesh)
    assert [p.tolist() for p in parts] == \
        [p.tolist() for p in torch.tensor_split(x, 3, dim=0)]
    assert [p.shape for p in tsh.place(x, ("model", 1), mesh)] == \
        [(7, 2), (7, 2)]
    reps = tsh.place(x, None, mesh, "model")
    assert len(reps) == 2 and all(torch.equal(r, x) for r in reps)
    st = tsh.place(x, (("data", "model"),), mesh)
    assert [tuple(p.shape) for p in st.pieces.values()] == \
        [(2, 4), (1, 4), (1, 4), (1, 4), (1, 4), (1, 4)]
    assert torch.equal(st.gather(), x)
    st = tsh.place(x, (None, ("model",)), mesh)
    assert len(st.pieces) == 6 and torch.equal(st.gather(), x)
    assert torch.equal(tsh.place(x, (), mesh).gather(), x)


# ------------------------------------------------------------------ MoE


def _moe_inputs(ref, TT_):
    names = ("x", "router", "wg", "wu", "wd")
    return [torch.tensor(ref[f"moe/in/{n}"][:TT_] if n == "x"
                         else ref[f"moe/in/{n}"], requires_grad=True)
            for n in names]


def _drops(x, router, k, cf, groups):
    """Assignments past their expert's capacity in each of ``groups``
    contiguous token groups."""
    out = []
    for xl in x.detach().split(x.shape[0] // groups):
        probs = torch.softmax(xl @ router.detach(), -1)
        _, ids = TM._top_k(probs, k)
        E = router.shape[-1]
        C = max(1, int(np.ceil(xl.shape[0] * k / E * cf)))
        counts = torch.bincount(ids.reshape(-1), minlength=E)
        out.append(int((counts - C).clamp(min=0).sum()))
    return out


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mesh_branch_equals_reference(ref_mesh, case):
    """``moe_ffn`` under a (G, 1) mesh: y, aux and the gradients of x,
    the router and the three expert weights against the reference's
    ``shard_map`` branch. At G = 2 and 4 the capacity binds in some
    groups and not in others, and the one-group path drops nothing, so
    its answer differs; T = 42 over 4 groups takes the local path in
    both."""
    G, T = MOE_CASES[case]
    key = f"moe/{G}/{T}"
    ins = _moe_inputs(ref_mesh, T)
    ct = torch.tensor(ref_mesh["moe/in/ct"][:T])
    with tsh.use_mesh_rules(_cpu_mesh((G, 1))):
        y, aux = TM.moe_ffn(*ins, MOE_K, MOE_CF)
    grads = torch.autograd.grad((y * ct).sum() + 3.0 * aux, ins)
    assert _rel(_np(y), ref_mesh[f"{key}/y"]) <= TOL
    assert abs(aux.item() - float(ref_mesh[f"{key}/aux"])) <= \
        TOL * abs(float(ref_mesh[f"{key}/aux"]))
    for name, g in zip(("x", "router", "w_gate", "w_up", "w_down"), grads):
        assert _rel(_np(g), ref_mesh[f"{key}/g/{name}"]) <= TOL, name
    y1, _ = TM.moe_ffn(*ins, MOE_K, MOE_CF)
    if case == "uneven":
        assert torch.equal(y, y1)
        return
    drops = _drops(ins[0], ins[1], MOE_K, MOE_CF, G)
    assert max(drops) > 0 and min(drops) == 0, drops
    assert _drops(ins[0], ins[1], MOE_K, MOE_CF, 1) == [0]
    assert not torch.allclose(y, y1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [2, 4])
def test_moe_mesh_branch_is_the_composition_of_local_groups(G, dtype):
    """The branch equals, bit for bit, ``_moe_local`` on each of the G
    contiguous groups (each casting the float32 weights itself), outputs
    concatenated and the aux losses averaged, and so do the gradients
    of the tokens and of every weight; a (pod, data) mesh orders the
    groups row-major."""
    rng = np.random.default_rng(G)
    T, d, f, E = 64, 8, 12, 4
    shapes = ((T, d), (d, E), (E, d, f), (E, d, f), (E, f, d))
    ct = torch.tensor(rng.normal(size=(T, d)).astype(np.float32)).to(dtype)
    base = [torch.tensor(rng.normal(size=s).astype(np.float32))
            for s in shapes]

    def run(mesh):
        args = [base[0].to(dtype).requires_grad_()] + \
            [b.clone().requires_grad_() for b in base[1:]]
        if mesh is None:
            parts = [TM._moe_local(xl, *args[1:], 2, 1.0)
                     for xl in args[0].split(T // G)]
            y = torch.cat([p[0] for p in parts])
            aux = torch.stack([p[1] for p in parts]).mean()
        else:
            with tsh.use_mesh_rules(mesh):
                y, aux = TM.moe_ffn(*args, 2, 1.0)
        grads = torch.autograd.grad((y * ct).sum() + aux, args)
        return y, aux, grads

    want = run(None)
    got = run(_cpu_mesh((2, G // 2, 1)))
    assert got[0].dtype == dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_moe_lm_loss_under_mesh_equals_reference(ref_mesh):
    """A smoke MoE LM (mixtral smoke, float32, cf MOE_CF, wq / wk / wv
    conditioned as in tests/test_torch_lm.py) on a (2, 2) mesh:
    ``lm_loss`` and every leaf's gradient against the reference's under
    ``use_mesh_rules``; the loss differs from the one-group path's."""
    cfg = _lm_cfg()
    model = _fill(TT.LMParams(cfg, device="cpu"), ref_mesh, "lm/p")
    batch = {"tokens": ref_mesh["lm/tokens"], "targets": ref_mesh["lm/targets"]}

    def loss(p, b):
        return TT.lm_loss(cfg, p, b["tokens"], b["targets"])
    with tsh.use_mesh_rules(_cpu_mesh((2, 2))):
        got, grads = value_and_grad(loss, model, batch)
    assert abs(got.item() - float(ref_mesh["lm/loss"])) <= \
        TOL * abs(float(ref_mesh["lm/loss"]))
    for n, g in grads.items():
        assert _rel(_np(g), ref_mesh[f"lm/g/{n}"]) <= TOL, n
    one, _ = value_and_grad(loss, model, batch)
    assert one.item() != got.item()


# ---------------------------------------------------------- sharded GCN


def _graph(name, pkg):
    if name == "ba150":
        gen = rgen if pkg == "ref" else tgen
        return gen.barabasi_albert(150, 3, seed=2, directed=False)
    if pkg == "ref":
        return oracle.cases()[name]
    return oracle_port_cases()[name]


@functools.lru_cache(maxsize=None)
def oracle_port_cases():
    """The oracle zoo's graphs carried into the port's ``Graph``."""
    from repro_torch.graph import csr as tcsr
    return {n: tcsr.Graph(**{f.name: getattr(g, f.name)
                             for f in dataclasses.fields(g)})
            for n, g in oracle.cases().items()}


def _gcn_cfg():
    return tbase.get("gcn-cora").smoke()


@pytest.mark.parametrize("ns", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_build_sharded_gcn_batch_equals_reference_bits(name, ns):
    cfg = _gcn_cfg()
    ref = RGS.build_sharded_gcn_batch(_graph(name, "ref"), cfg.d_in,
                                      cfg.n_classes, ns, seed=1)
    got = TGS.build_sharded_gcn_batch(_graph(name, "port"), cfg.d_in,
                                      cfg.n_classes, ns, seed=1)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)
    wide = TGS.build_sharded_gcn_batch(_graph(name, "port"), cfg.d_in,
                                       cfg.n_classes, ns, e_max=1024, seed=1)
    assert wide["blk_src"].shape == (ns, 1024)
    w = got["blk_src"].shape[1]
    np.testing.assert_array_equal(wide["blk_w"][:, :w], got["blk_w"])
    with pytest.raises(ValueError):
        TGS.build_sharded_gcn_batch(_graph(name, "port"), cfg.d_in,
                                    cfg.n_classes, ns, e_max=w - 1)


def _sharded_loss(cfg):
    return lambda p, b: TGS.gcn_loss_sharded(cfg, p, b)


@pytest.mark.parametrize("ns", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_gcn_loss_sharded_equals_reference(ref_mesh, name, ns):
    """The loss and every leaf's gradient on NS CPU shards against the
    reference's ``shard_map`` GCN on NS forced host devices."""
    cfg = _gcn_cfg()
    model = _fill(TG.GNNParams(cfg, device="cpu"), ref_mesh, "gcn/p")
    batch = TGS.build_sharded_gcn_batch(_graph(name, "port"), cfg.d_in,
                                        cfg.n_classes, ns, seed=1)
    with tsh.use_mesh_rules(_cpu_mesh((ns,), ("data",))):
        loss, grads = value_and_grad(_sharded_loss(cfg), model, batch)
    key = f"gcn/{name}/{ns}"
    ref = float(ref_mesh[f"{key}/loss"])
    assert abs(loss.item() - ref) <= TOL * abs(ref)
    for n, g in grads.items():
        assert _rel(_np(g), ref_mesh[f"{key}/g/{n}"]) <= TOL, n


def test_gcn_loss_sharded_needs_a_mesh_that_fits_the_batch():
    cfg = _gcn_cfg()
    model = TG.GNNParams(cfg, device="cpu")
    batch = TGS.build_sharded_gcn_batch(_graph("er", "port"), cfg.d_in,
                                        cfg.n_classes, 4)
    with pytest.raises(ValueError, match="active mesh"):
        TGS.gcn_loss_sharded(cfg, model, batch)
    with tsh.use_mesh_rules(_cpu_mesh((2,), ("data",))):
        with pytest.raises(ValueError, match="node shards"):
            TGS.gcn_loss_sharded(cfg, model, batch)


def _sharded_step(cfg, opt):
    """The reference's inline step (launch/specs.py's shardmap cell):
    the value and gradient of ``gcn_loss_sharded``, then AdamW."""
    def step(params, state, batch):
        loss, grads = value_and_grad(_sharded_loss(cfg), params, batch)
        params, state = opt.update(grads, state, params)
        return params, state, loss
    return step


@pytest.mark.parametrize("shape", [(4,), (2, 2), (2, 1, 2)])
def test_sharded_gcn_equals_the_unsharded_port(shape):
    """On a mesh of 4 node shards (over "data", over ("data", "model"),
    over ("pod", "model")) the sharded loss and gradients equal the
    unsharded ``gnn.loss_fn``'s on the same graph within TOL."""
    cfg = _gcn_cfg()
    g = _graph("ba150", "port")
    model = TG.GNNParams(cfg, torch.Generator().manual_seed(4))
    from repro_torch.data.pipeline import gnn_batch
    ref, ref_g = value_and_grad(lambda p, b: TG.loss_fn(cfg, p, b), model,
                                gnn_batch(g, cfg.d_in, cfg.n_classes, seed=1))
    batch = TGS.build_sharded_gcn_batch(g, cfg.d_in, cfg.n_classes, 4, seed=1)
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]
    with tsh.use_mesh_rules(_cpu_mesh(shape, axes)):
        loss, grads = value_and_grad(_sharded_loss(cfg), model, batch)
    assert abs(loss.item() - ref.item()) <= TOL * abs(ref.item())
    for n, gr in grads.items():
        assert _rel(_np(gr), _np(ref_g[n])) <= TOL, n


def test_elastic_resume_on_the_mesh_remesh_plans(tmp_path):
    """Five sharded steps on four shards; the same run saved after step
    3, restored under the two-shard mesh ``remesh`` plans (every leaf
    placed, gathered to the saved bits) and stepped twice on that mesh:
    the two losses within TOL of the uninterrupted run's."""
    cfg = _gcn_cfg()
    g = _graph("ba150", "port")
    opt = AdamW(lr=1e-2)
    step = _sharded_step(cfg, opt)
    b4 = TGS.build_sharded_gcn_batch(g, cfg.d_in, cfg.n_classes, 4, seed=1)
    b2 = TGS.build_sharded_gcn_batch(g, cfg.d_in, cfg.n_classes, 2, seed=1)
    model = TG.GNNParams(cfg, torch.Generator().manual_seed(4))
    state = opt.init(model)
    losses, saved = [], None
    with tsh.use_mesh_rules(_cpu_mesh((4, 1))):
        for k in range(5):
            model, state, loss = step(model, state, b4)
            losses.append(loss.item())
            if k == 2:
                tckpt.save(str(tmp_path), 3, model, state)
                saved = {n: t.detach().clone() for n, t in
                         tsh.tree_paths(model) + tsh.tree_paths(state)}
    plan = telastic.remesh(2, 1, 8, 4)
    mesh2 = telastic.make_mesh_from_plan(plan, devices=["cpu"] * 2)
    assert plan.mesh_shape == (2, 1) and plan.grad_accum == 2
    like = TG.GNNParams(cfg, torch.Generator().manual_seed(9))
    like_state = opt.init(like)
    ps = tsh.tree_shardings(like, mesh2)
    os_ = AdamWState(step=tsh.NamedSharding(mesh2, ()), m=ps, v=ps)
    rp, ro, mf = tckpt.restore(str(tmp_path), 3, like, like_state, mesh2,
                               ps, os_)
    assert mf["step"] == 3
    restored = {**{n: t.gather() for n, t in rp.items()},
                **{n: t.gather() for n, t in tsh.tree_paths(ro)}}
    assert restored.keys() == saved.keys()
    for n, t in saved.items():
        assert torch.equal(restored[n], t), n
    with torch.no_grad():
        for n, p in named_leaves(like):
            p.copy_(restored[n])
    state2 = AdamWState(step=restored[".step"],
                        m={n: restored[f".m/{n}"] for n in like_state.m},
                        v={n: restored[f".v/{n}"] for n in like_state.v})
    with tsh.use_mesh_rules(mesh2):
        for k in range(2):
            like, state2, loss = step(like, state2, b2)
            assert abs(loss.item() - losses[3 + k]) <= TOL * losses[3 + k]


# ---------------------------------------------------------- checkpoints


@pytest.mark.parametrize("mesh", [m for m, _ in CK_MESHES])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_restore_under_a_new_mesh_equals_reference(ref_mesh, writer, mesh):
    """A checkpoint written by either package (the reference's under a
    (4, 1) mesh) restored by both under ``mesh``'s ``tree_shardings``
    for the parameters and the AdamW state: equal whole arrays, the
    same index slices at each mesh position, and equal pieces there."""
    shape = dict(CK_MESHES)[mesh]
    cfg = _lm_cfg()
    tmesh_ = _cpu_mesh(shape)
    like = TT.LMParams(cfg, torch.Generator().manual_seed(11), device="cpu")
    like_state = AdamW().init(like)
    ps = tsh.tree_shardings(like, tmesh_)
    os_ = AdamWState(step=tsh.NamedSharding(tmesh_, ()), m=ps, v=ps)
    path = ref_mesh["dir"] / f"{writer}_ckpt"
    rp, ro, _ = tckpt.restore(str(path), 2, like, like_state, tmesh_, ps,
                              os_)
    got = {**{f"p/{n}": t for n, t in rp.items()},
           **{f"o/{n}": t for n, t in tsh.tree_paths(ro)}}
    prefix = f"ck/{writer}/{mesh}"
    keys = {k[len(prefix) + 1:-6] for k in ref_mesh
            if k.startswith(prefix) and k.endswith("/whole")}
    assert set(got) == keys
    if writer == "port":
        src = {**{f"p/{n}": t for n, t in named_leaves(ref_mesh["model"])},
               **{f"o/{n}": t for n, t in tsh.tree_paths(ref_mesh["state"])}}
    for k, st in got.items():
        whole = ref_mesh[f"{prefix}/{k}/whole"]
        np.testing.assert_array_equal(st.gather().numpy(), whole, err_msg=k)
        if writer == "port":
            np.testing.assert_array_equal(src[k].detach().numpy(), whole)
        idx = st.sharding.devices_indices_map(st.shape)
        got_idx = np.asarray([[(s.start, s.stop) for s in sl]
                              for sl in idx.values()], np.int64)
        want = ref_mesh[f"{prefix}/{k}/idx"]
        np.testing.assert_array_equal(got_idx.reshape(want.shape), want,
                                      err_msg=k)
        data = ref_mesh[f"{prefix}/{k}/data"]
        for i, pos in enumerate(idx):
            np.testing.assert_array_equal(st.pieces[pos].numpy(), data[i],
                                          err_msg=k)


def test_restore_without_shardings_fills_in_place(tmp_path):
    model, state = _port_ckpt_state()
    tckpt.save(str(tmp_path), 1, model, state)
    like = TT.LMParams(_lm_cfg(), torch.Generator().manual_seed(2),
                       device="cpu")
    like_state = AdamW().init(like)
    out, ost, _ = tckpt.restore(str(tmp_path), 1, like, like_state)
    assert out is like and ost is like_state
    for (n, a), (_, b) in zip(tsh.tree_paths(model) + tsh.tree_paths(state),
                              tsh.tree_paths(like) + tsh.tree_paths(ost)):
        assert torch.equal(a.detach(), b.detach()), n


# -------------------------------------------------------------- oracles


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_join_ref_equals_reference(case):
    rng = np.random.default_rng(len(case))
    ku, vu, kv, vv = join_rows(rng, **JOIN_CASES[case])
    ref = np.asarray(rjoin_ref.join_ref(*map(jnp.asarray, (ku, vu, kv, vv))))
    got = join_ref(*map(torch.as_tensor, (ku, vu, kv, vv))).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert PAD == int(rjoin_ref.PAD)


@pytest.mark.parametrize("f", [1, 16])
def test_spmm_ref_equals_reference(f):
    rng = np.random.default_rng(f)
    n, m = 90, 400
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.05, 0.6, m).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ref = np.asarray(rspmm_ref.spmm_ref(jnp.asarray(x), jnp.asarray(src),
                                        jnp.asarray(dst), jnp.asarray(w), n))
    got = spmm_ref(torch.as_tensor(x), torch.as_tensor(src),
                   torch.as_tensor(dst), torch.as_tensor(w), n).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("module", NEW_MODULES)
def test_modules_import_neither_jax_nor_the_reference(module):
    tree = ast.parse((ROOT / "src" / "repro_torch" / module).read_text())
    mods = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
            for a in node.names]
    mods += [node.module for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]
