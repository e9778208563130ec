"""The partitioned MoE-LM steps (``models/transformer_sharded.py``) held
against the JAX reference's functions under a mesh on the CPU, at the
mixtral-8x22b and llama4-scout-17b-a16e ``smoke()`` sizes in float32 with
attn_chunk = loss_chunk = 8; beside them the pieces they are built of
(``collectives.reduce_scatter``, the sliced loss) and the MoE cells' dry
run on a fake (4, 4) mesh.

The reference's answers come from one subprocess that forces four host
devices (``tests/test_torch_sharding.py``'s way), started with the
module's first test: its ``lm_loss`` under ``jax.value_and_grad``, its
``prefill`` of B = 4 rows and three greedy ``decode_step`` s from that
cache's first 4 and first 1 rows (padded by 4 slots), under
``use_mesh_rules`` on (2, 2) and (4, 1) ("data", "model") meshes and
with no mesh. A mesh changes the MoE layer's function: its tokens
dispatch in one group a data shard, each with its own capacity
``ceil(T_l * k / E * cf)``; CF makes the capacity bind in some groups
and not in others. The parameters are the reference's init with wq, wk
and wv rescaled to fan_in d_model (``tests/test_torch_lm.py``'s
``_conditioned``), carried by ``convert.lm_params_from_jax``.

The port's partitioned steps run on ``["cpu"] * n`` meshes: (2, 2) and
(4, 1), where "model" splits the experts (EP); (2, 2) with the rules
``{"experts_w": [None]}`` and (1, 8), where it splits d_ff (TP); (1, 3),
where it splits neither and the 16 tokens cut 6, 5, 5. (1, 8) and (1, 3)
have one data group, so their reference is the no-mesh run. float32 is
held at TOL = 1e-5: the loss, each leaf's gradient (of its max |g|),
prefill's logits and cache, each decode step's logits and the cache
after them (of their max |ref|).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import collectives as C
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models import transformer_sharded as TS

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")
TOL = 1e-5
B, S, PAD = 4, 16, 4
CF = 1.75
TP = {"experts_w": [None]}
WEIGHTS = re.compile(r"^(blocks/\w+|embed)@.*model")
# (mesh, rules, the reference run it is held to)
CASES = {"ep22": ((2, 2), None, "22"), "ep41": ((4, 1), None, "41"),
         "tp22": ((2, 2), TP, "22"), "tp18": ((1, 8), None, "none"),
         "uneven13": ((1, 3), None, "none")}

REF = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = ["src"]
import contextlib
import numpy as np
import jax, jax.numpy as jnp, jax.random as jr
from jax.sharding import Mesh
from repro.configs import base as rbase
from repro.launch import sharding as sh
from repro.models import transformer as RT
from repro.train import checkpoint as rckpt

B, S, PAD, CF = %(B)d, %(S)d, %(PAD)d, %(CF)r
out = {}
rng = np.random.default_rng(11)
toks = rng.integers(0, 512, (B, S)).astype(np.int32)
tgts = rng.integers(0, 512, (B, S)).astype(np.int32)
out["tokens"], out["targets"] = toks, tgts

def names(tree):
    n, l, _ = rckpt._flatten(tree)
    return dict(zip(n, l))

@contextlib.contextmanager
def on(shape):
    if shape is None:
        yield
        return
    m = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))],
                        dtype=object).reshape(shape), ("data", "model"))
    with m, sh.use_mesh_rules(m):
        yield

for arch in %(archs)r:
    cfg = dataclasses.replace(rbase.get(arch).smoke(), dtype=jnp.float32,
                              capacity_factor=CF)
    params = RT.init_params(cfg, jr.PRNGKey(0))
    blocks = dict(params["blocks"])      # tests/test_torch_lm.py's _conditioned
    for nm, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                      ("wv", cfg.n_kv_heads)):
        blocks[nm] = blocks[nm] * np.float32(np.sqrt(heads / cfg.d_model))
    params = {**params, "blocks": blocks}
    for k, v in names(params).items():
        out[f"{arch}/p/{k}"] = v
    for tag, shape in (("22", (2, 2)), ("41", (4, 1)), ("none", None)):
        key = f"{arch}/{tag}"
        with on(shape):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: RT.lm_loss(cfg, p, toks, tgts)))(params)
            out[key + "/loss"] = loss
            for k, v in names(grads).items():
                out[f"{key}/g/{k}"] = v
            logits, cache = jax.jit(lambda p, t: RT.prefill(cfg, p, t))(
                params, toks)
            out[key + "/prefill"], out[key + "/k0"], out[key + "/v0"] = (
                logits, cache["k"], cache["v"])
            decode = jax.jit(lambda p, c, t: RT.decode_step(cfg, p, c, t))
            for b in (B, 1):
                pad = ((0, 0), (0, 0), (0, PAD), (0, 0), (0, 0))
                c = {"k": jnp.pad(cache["k"][:, :b], pad),
                     "v": jnp.pad(cache["v"][:, :b], pad), "len": cache["len"]}
                fed = [np.asarray(jnp.argmax(logits[:b], -1), np.int32)]
                for i in range(3):
                    lg, c = decode(params, c, jnp.asarray(fed[-1]))
                    out[f"{key}/decode/{b}/{i}"] = lg
                    fed.append(np.asarray(jnp.argmax(lg, -1), np.int32))
                out[f"{key}/decode/{b}/k"] = c["k"]
                out[f"{key}/decode/{b}/v"] = c["v"]
                out[f"{key}/fed/{b}"] = np.stack(fed[:3])
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
print("REF_MOE_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ops here are tiny and dispatch-bound: one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's subprocess, started with the module's first test."""
    d = tmp_path_factory.mktemp("ref_moe")
    code = REF % {"B": B, "S": S, "PAD": PAD, "CF": CF, "archs": ARCHS}
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(d / "ref.npz")], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    yield d, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _start_reference(ref_run):
    """Start the reference's subprocess with the module's first test."""


@pytest.fixture(scope="module")
def ref(ref_run):
    d, proc = ref_run
    out, err = proc.communicate(timeout=300)
    assert "REF_MOE_OK" in out, out + err
    with np.load(d / "ref.npz") as z:
        return dict(z)


def _cfg(arch):
    return dataclasses.replace(tbase.get(arch).smoke(), dtype=torch.float32,
                               capacity_factor=CF)


def _model(arch, ref):
    """A fresh port copy of the reference's parameters."""
    flat = {k[len(arch) + 3:]: v for k, v in ref.items()
            if k.startswith(arch + "/p/")}
    tree = {"embed": flat["embed"], "ln_f": flat["ln_f"],
            "blocks": {k[7:]: v for k, v in flat.items()
                       if k.startswith("blocks/")}}
    return convert.lm_params_from_jax(_cfg(arch), tree, device="cpu")


def _mesh(shape):
    return make_debug_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, sh.ShardedTensor):
        t = t.gather()
    return t.detach().to(torch.float32).numpy()


def _assemble(st, pieces) -> np.ndarray:
    full = np.zeros(st.shape, np.float32)
    for p, sl in st.sharding.devices_indices_map(st.shape).items():
        full[sl] = _np(pieces[p])
    return full


# ------------------------------------------- dry run (before the reference)

SMALL_SHAPES = {"train_4k": dict(kind="train", seq=256, batch=16),
                "prefill_32k": dict(kind="prefill", seq=256, batch=4),
                "decode_32k": dict(kind="decode", seq=256, batch=4),
                "long_500k": dict(kind="decode", seq=1024, batch=1)}


@pytest.mark.parametrize("shape_name", list(SMALL_SHAPES))
def test_moe_cells_read_pieces_and_gather_nothing(monkeypatch, shape_name):
    """The MoE smoke cells (bf16, chunks of 64) on a fake (4, 4) mesh:
    every argument read as its pieces, no "gather" collective; train and
    prefill move their MoE output by reduce-scatter; decode gathers no
    weight over the model axis."""
    for arch in ARCHS:
        spec = tbase.get(arch)
        small = dataclasses.replace(spec.smoke(), dtype=torch.bfloat16,
                                    attn_chunk=64, loss_chunk=64)
        monkeypatch.setitem(tbase._REGISTRY, arch, dataclasses.replace(
            spec, full=lambda small=small: small))
    monkeypatch.setattr(specs, "LM_SHAPE_DEFS", SMALL_SHAPES)
    mesh = make_debug_mesh((4, 4), devices=dryrun.fake_devices(16))
    kind = SMALL_SHAPES[shape_name]["kind"]
    for arch in ARCHS:
        cell = specs.make_cell(arch, shape_name, mesh)
        assert cell.piecewise == ((0, 1) if kind == "prefill" else (0, 1, 2))
        walk, _ = dryrun.trace_cell(cell)
        assert "gather" not in walk.coll_by_op, walk.coll_by_op
        if kind in ("train", "prefill"):
            assert "reduce-scatter" in walk.coll_by_op
        if kind == "decode":
            moved = [r.op for r in walk.records if r.kind == "all-gather"
                     and WEIGHTS.match(r.op)]
            assert not moved, moved


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("shape,axes", [((2, 2), ("model",)),
                                        ((1, 3), ("model",)),
                                        ((2, 2), ("data", "model"))])
def test_reduce_scatter_is_all_reduce_then_a_slice(shape, axes):
    """Forward: bit for bit ``all_reduce`` over the same axes, then each
    position's own region (rows whole, an uneven column cut). Backward:
    each part's gradient bit for bit ``all_gather`` of the output
    gradients at their regions."""
    mesh = _mesh(shape)
    pos = C.positions(mesh)
    S_ = C.Spmd(mesh, pos, False)
    g = torch.Generator().manual_seed(1)
    n, m = 3, 11
    parts = {p: torch.randn((n, m), generator=g).requires_grad_()
             for p in pos}
    outg = {p: torch.randn((n, m), generator=g) for p in pos}

    def region(q):
        j, k = C.group_index(mesh, q, axes)
        return ((0, n), sh._bounds(m, k, j))
    got = C.reduce_scatter(S_, parts, axes, region, dtype=torch.bfloat16)
    whole = C.all_reduce(S_, parts, axes, dtype=torch.bfloat16)
    for p in pos:
        lo, hi = region(p)[1]
        assert got[p].dtype == torch.bfloat16
        assert torch.equal(got[p], whole[p][:, lo:hi]), p
    grads = torch.autograd.grad(
        [got[p] for p in pos],
        [parts[p] for p in pos],
        [outg[p][:, slice(*region(p)[1])].to(torch.bfloat16) for p in pos])
    want = C.all_gather(S_, {p: outg[p][:, slice(*region(p)[1])].to(
        torch.bfloat16) for p in pos}, axes, region, lambda p: (n, m),
        dtype=torch.float32)
    for p, gr in zip(pos, grads):
        assert gr.dtype == torch.float32
        assert torch.equal(gr, want[p]), p


@pytest.mark.parametrize("width", [128, 96])
def test_chunk_nll_sliced_equals_chunk_nll(width):
    """The sliced loss (a width that divides V = 512, one that does not)
    against ``transformer._chunk_nll``: value, and the gradients of x and
    of the embedding, within 1e-6 of their max."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 8, 24), generator=g)
    emb = torch.randn((512, 24), generator=g) * 0.3
    t = torch.randint(0, 512, (3, 8), generator=g)
    t[0, :4] = torch.tensor([0, 511, 95, 96])      # slice edges
    a = [x.clone().requires_grad_(), emb.clone().requires_grad_()]
    b = [x.clone().requires_grad_(), emb.clone().requires_grad_()]
    want = TT._chunk_nll(a[0], t, a[1])
    got = TS._chunk_nll_sliced(b[0], t, b[1], width)
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())
    gw = torch.autograd.grad(want * 1.7, a)
    gg = torch.autograd.grad(got * 1.7, b)
    for u, v in zip(gg, gw):
        assert _rel(u.numpy(), v.numpy()) <= 1e-6


# ----------------------------------------------------------- the MoE steps


def _routes(monkeypatch):
    """The kept-all flag of every dispatch, in call order."""
    seen = []
    real = TM.dispatch

    def spy(*a, **k):
        r = real(*a, **k)
        seen.append(bool(r.ok.all()))
        return r
    monkeypatch.setattr(TM, "dispatch", spy)
    return seen


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_mesh_equals_reference(ref, arch, case):
    """The partitioned loss (the NLL and 0.01 x the aux loss) and every
    leaf's gradient, assembled from the pieces', against
    ``jax.value_and_grad`` of the reference's ``lm_loss`` under its mesh;
    the expert weights stay split over "model" as the case says."""
    shape, rules, tag = CASES[case]
    cfg, mesh = _cfg(arch), _mesh(shape)
    with sh.use_mesh_rules(mesh, rules):
        params = TS.place_params(_model(arch, ref))
        spec = params["blocks/moe_w_gate"].sharding.spec
        loss, grads = TS.value_and_grad(cfg, params, ref["tokens"],
                                        ref["targets"])
    if case.startswith("ep"):
        assert spec[1] == ("model",), spec
    elif case.startswith("tp"):
        assert spec[3] == ("model",), spec
    else:
        assert "model" not in {a for e in spec for a in (e or ())}, spec
    key = f"{arch}/{tag}"
    assert _rel(float(loss), ref[key + "/loss"]) <= TOL
    for n, st in params.items():
        assert _rel(_assemble(st, grads[n]), ref[f"{key}/g/{n}"]) <= TOL, n


def test_capacity_binds_in_some_groups_and_not_in_others(ref, monkeypatch):
    """At CF, each arch's groups on the (2, 2) and (4, 1) meshes dispatch
    with drops in some and none in others (its prefills' calls)."""
    for arch in ARCHS:
        cfg = _cfg(arch)
        seen = _routes(monkeypatch)
        for shape in ((2, 2), (4, 1)):
            with sh.use_mesh_rules(_mesh(shape)):
                params = TS.place_params(_model(arch, ref))
                TS.prefill(cfg, params, ref["tokens"])
        assert True in seen and False in seen, (arch, seen)


@pytest.mark.parametrize("batch", [B, 1])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_mesh_equal_reference(ref, arch, case, batch):
    """The partitioned prefill of B rows (logits, and its cache gathered
    from the pieces), then its first ``batch`` rows' cache padded by PAD
    and placed by the decode rules, and three partitioned decode steps on
    the reference's greedy tokens: their logits and the cache after them,
    each within TOL of the reference's under its mesh."""
    shape, rules, tag = CASES[case]
    cfg, mesh = _cfg(arch), _mesh(shape)
    key = f"{arch}/{tag}"
    params = TS.place_params(_model(arch, ref), mesh)
    with sh.use_mesh_rules(mesh, specs.lm_rules("prefill", B, rules)):
        logits, cache = TS.prefill(cfg, params, ref["tokens"])
    assert _rel(_np(logits), ref[key + "/prefill"]) <= TOL
    k0, v0 = (cache[n].gather() for n in "kv")
    assert _rel(_np(k0), ref[key + "/k0"]) <= TOL
    assert _rel(_np(v0), ref[key + "/v0"]) <= TOL
    with sh.use_mesh_rules(mesh, specs.lm_rules("decode", batch, rules)):
        padded = TT.pad_cache({"k": k0[:, :batch], "v": v0[:, :batch],
                               "len": S}, S + PAD)
        names = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        spec = sh.spec_for(tuple(padded["k"].shape), names, mesh)
        cache = {"k": sh.place(padded["k"], spec, mesh),
                 "v": sh.place(padded["v"], spec, mesh), "len": S}
        fed = ref[f"{key}/fed/{batch}"]
        for i, token in enumerate(fed):
            logits, cache = TS.decode_step(cfg, params, cache,
                                           torch.tensor(token))
            assert _rel(_np(logits), ref[f"{key}/decode/{batch}/{i}"]) \
                <= TOL, i
    assert cache["len"] == S + 3
    assert _rel(_np(cache["k"]), ref[f"{key}/decode/{batch}/k"]) <= TOL
    assert _rel(_np(cache["v"]), ref[f"{key}/decode/{batch}/v"]) <= TOL


def test_decode_refuses_rows_that_are_not_a_group(ref):
    """A batch placed over "data" alone on a ("pod", "data", "model") mesh
    whose groups do not divide it: the position's rows are not the
    reference's group, and the MoE decode says so."""
    arch = ARCHS[0]
    cfg = _cfg(arch)
    mesh = make_debug_mesh((2, 2, 1), ("pod", "data", "model"),
                           devices=["cpu"] * 4)
    rules = dict(specs.lm_rules("decode", 2), batch=[("data",)],
                 kv_seq=[("pod", "model")])
    with sh.use_mesh_rules(mesh, rules):
        params = TS.place_params(_model(arch, ref))
        shape = (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.d_head)
        spec = sh.spec_for(shape, ("layers", "batch", "kv_seq", "kv_heads",
                                   "head_dim"), mesh)
        cache = {n: sh.place(torch.zeros(shape), spec, mesh) for n in "kv"}
        with pytest.raises(ValueError, match="data groups"):
            TS.decode_step(cfg, params, dict(cache, len=4),
                           torch.zeros(2, dtype=torch.int32))
