"""The partitioned dense-LM steps (``models/transformer_sharded.py``)
held against the JAX reference's unpartitioned functions on the CPU, at
``smoke()`` sizes with attn_chunk = loss_chunk = 8, on meshes of
``["cpu"] * n`` (GSPMD does not change the function, so the reference
runs with no mesh); then the dry run of the dense-LM cells on a fake
(4, 4) mesh.

The same numpy-seeded parameters (the reference's init with wq, wk and
wv rescaled to fan_in d_model, as ``tests/test_torch_lm.py``'s
``_conditioned``, carried by ``convert.lm_params_from_jax``) and tokens
go through the reference's ``lm_loss`` under ``jax.value_and_grad``,
``prefill`` and ``decode_step``, and through the port's partitioned
steps, on (2, 2), (1, 4) and (4, 1), and on (1, 3) for a sequence that
splits unevenly (16 tokens as 6, 5, 5). float32 is held at TOL =
1e-5: the loss, each leaf's gradient (of its max |g|), prefill's logits
and its cache gathered from its pieces, three decode steps' logits and
the cache after them (of their max |ref|); one AdamW step's pieces,
gathered, within TOL (absolute) of the unpartitioned update on the same
gradients; after the whole partitioned step, within TOL of the
unpartitioned port step on all but 1 in 10,000 entries and within
UPDATE_WORST lr on every one (AdamW's first step divides a gradient by
its own size, so an entry whose gradient is near zero turns a float32
difference in it into a sizable one: measured at most 0.030 lr, on at
most one entry a case, none over TOL for smollm-135m). Decode
runs at batch 4 (rows over "data", slots over "model") and at batch 1
(slots over "data" and "model"). One bf16 case holds a whole model at
4 bf16 ulps on outputs and 8 on gradients, as ``tests/test_torch_lm.py``
does.

The dry-run cases patch the registry's ``full()`` to the smoke configs
and the LM shape table to small shapes, as the chip smoke's rehearsals
do.
"""
import copy
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import transformer as RT
from repro.train import checkpoint as rckpt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import collectives as C
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import transformer as TT
from repro_torch.models import transformer_sharded as TS
from repro_torch.models.flash_attention import flash_attention
from repro_torch.optim import adamw as tadamw
from repro_torch.train import steps as tsteps

DENSE = ("smollm-135m", "gemma3-1b", "qwen3-14b")
MESHES = ((2, 2), (1, 4), (4, 1))
UNEVEN = (1, 3)
TOL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_OUT, BF16_GRAD = 4, 8
B, S = 4, 16
LR = 1e-3
UPDATE_WORST = 0.1    # of lr: one partitioned step's parameter, at most
VOCAB_SLICE_SMOKE = 96    # the loss's vocabulary slice: 512 cut 5 x 96 + 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ops here are tiny and dispatch-bound: one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, dtype="float32"):
    r, t = rbase.get(arch).smoke(), tbase.get(arch).smoke()
    return (dataclasses.replace(r, dtype=getattr(jnp, dtype)),
            dataclasses.replace(t, dtype=getattr(torch, dtype)))


def _conditioned(rcfg, params):
    blocks, d = dict(params["blocks"]), rcfg.d_model
    for name, heads in (("wq", rcfg.n_heads), ("wk", rcfg.n_kv_heads),
                        ("wv", rcfg.n_kv_heads)):
        blocks[name] = blocks[name] * np.float32(np.sqrt(heads / d))
    return {**params, "blocks": blocks}


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype="float32"):
    rcfg, _ = _cfgs(arch, dtype)
    return _conditioned(rcfg, RT.init_params(rcfg, jr.PRNGKey(0)))


def _model(arch, dtype="float32"):
    """A fresh port copy of the reference's parameters."""
    _, tcfg = _cfgs(arch, dtype)
    return convert.lm_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, _ref_params(arch, dtype)),
        device="cpu")


def _tokens(vocab, shape=(B, S), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def _mesh(shape):
    return make_debug_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(float(np.abs(ref).max()), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, sh.ShardedTensor):
        t = t.gather()
    return t.detach().to(torch.float32).numpy()


def _assemble(st, pieces) -> np.ndarray:
    """The whole of a placed leaf from {position: piece}."""
    full = np.zeros(st.shape, np.float32)
    for p, sl in st.sharding.devices_indices_map(st.shape).items():
        full[sl] = _np(pieces[p])
    return full


@functools.lru_cache(maxsize=None)
def _ref_train(arch, dtype="float32"):
    rcfg, _ = _cfgs(arch, dtype)
    tokens, targets = _tokens(rcfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(rcfg, p, jnp.asarray(tokens),
                             jnp.asarray(targets))))(_ref_params(arch, dtype))
    names, leaves, _ = rckpt._flatten(grads)
    return float(loss), {n: np.asarray(g, np.float32)
                         for n, g in zip(names, leaves)}


@functools.lru_cache(maxsize=None)
def _ref_serve(arch, batch, dtype="float32"):
    """(prefill logits, the cache, three greedy decode steps' logits and
    the cache after them, the fed tokens) of the reference over the
    first ``batch`` rows, the cache padded by 4."""
    rcfg, _ = _cfgs(arch, dtype)
    tokens = _tokens(rcfg.vocab)[0][:batch]
    params = _ref_params(arch, dtype)
    logits, cache = jax.jit(lambda p, t: RT.prefill(rcfg, p, t))(
        params, jnp.asarray(tokens))
    out = {"prefill": np.asarray(logits, np.float32),
           "k0": np.asarray(cache["k"], np.float32),
           "v0": np.asarray(cache["v"], np.float32)}
    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    cache = {"k": jnp.pad(cache["k"], pad), "v": jnp.pad(cache["v"], pad),
             "len": cache["len"]}
    decode = jax.jit(lambda p, c, t: RT.decode_step(rcfg, p, c, t))
    fed = [np.asarray(jnp.argmax(logits, -1), np.int32)]
    for i in range(3):
        logits, cache = decode(params, cache, jnp.asarray(fed[-1]))
        out[f"decode{i}"] = np.asarray(logits, np.float32)
        fed.append(np.asarray(jnp.argmax(logits, -1), np.int32))
    out["k"] = np.asarray(cache["k"], np.float32)
    out["v"] = np.asarray(cache["v"], np.float32)
    return out, tuple(fed[:3])


def _placed_state(opt, model, mesh):
    """The AdamW state of ``model`` placed as the train cell places it."""
    state = opt.init(model)
    shards = sh.tree_shardings(model, mesh)
    return tadamw.AdamWState(
        step=sh.place(state.step, (), mesh),
        m={n: shards[n].shard(t) for n, t in state.m.items()},
        v={n: shards[n].shard(t) for n, t in state.v.items()})


# ------------------------------------------------------------ flash offset


@pytest.mark.parametrize("window,isg", [(0, 1.0), (8, 0.0), (8, 1.0)])
def test_flash_attention_query_offset_is_a_slice_of_the_whole(window, isg):
    """Queries at an offset against the whole keys: the output and the
    q / k / v gradients equal those of the whole sequence's run
    restricted to the slice."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 32, 4, 8), generator=g) for _ in range(3))
    dout = torch.randn((2, 32, 4, 8), generator=g)
    lo, hi = 11, 22
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    whole = flash_attention(qa, ka, va, isg, window, 8)
    (whole[:, lo:hi] * dout[:, lo:hi]).sum().backward()
    qb, kb, vb = (t.clone().requires_grad_() for t in (q[:, lo:hi], k, v))
    part = flash_attention(qb, kb, vb, isg, window, 8, q_offset=lo)
    (part * dout[:, lo:hi]).sum().backward()
    assert torch.allclose(part, whole[:, lo:hi], atol=1e-6)
    assert torch.allclose(qb.grad, qa.grad[:, lo:hi], atol=1e-6)
    assert torch.allclose(kb.grad, ka.grad, atol=1e-6)
    assert torch.allclose(vb.grad, va.grad, atol=1e-6)


# ------------------------------------------------------------------ train


@pytest.mark.parametrize("arch,shape", [(a, m) for a in DENSE for m in MESHES]
                         + [("gemma3-1b", UNEVEN)])
def test_train_step_on_mesh_equals_reference(monkeypatch, arch, shape):
    """The partitioned loss (its chunks' logits VOCAB_SLICE_SMOKE rows of
    the vocabulary at a time) and every leaf's gradient (assembled from
    the pieces' gradients) against ``jax.value_and_grad`` of the
    reference's ``lm_loss``; AdamW over the pieces on the reference's
    gradients against the unpartitioned update on them; the whole
    partitioned step against the unpartitioned port step; the pieces'
    step counters."""
    monkeypatch.setattr(TS, "VOCAB_SLICE", VOCAB_SLICE_SMOKE)
    _, tcfg = _cfgs(arch)
    mesh = _mesh(shape)
    tokens, targets = _tokens(tcfg.vocab)
    ref_loss, ref_grads = _ref_train(arch)
    opt = tadamw.AdamW(lr=LR)
    step = _model(arch)
    step, _, _ = tsteps.lm_train_step(tcfg, opt)(
        step, opt.init(step), {"tokens": tokens, "targets": targets})
    on_ref = _model(arch)
    on_ref, _ = opt.update({n: torch.tensor(g)
                            for n, g in ref_grads.items()},
                           opt.init(on_ref), on_ref)
    with sh.use_mesh_rules(mesh):
        model = _model(arch)
        params = TS.place_params(model)
        state = _placed_state(opt, model, mesh)
        loss, grads = TS.value_and_grad(tcfg, params, tokens, targets)
        assert _rel(float(loss), ref_loss) <= TOL
        for n, st in params.items():
            assert _rel(_assemble(st, grads[n]), ref_grads[n]) <= TOL, n
        params, state = opt.update_placed(grads, state, params)
        model = _model(arch)
        same = TS.place_params(model)
        cut = {n: {p: torch.tensor(ref_grads[n][sl])
                   for p, sl in st.sharding.devices_indices_map(
                       st.shape).items()} for n, st in same.items()}
        same, _ = opt.update_placed(cut, _placed_state(opt, model, mesh),
                                    same)
    assert {int(t) for t in state.step.pieces.values()} == {1}
    want, want_ref = (dict(tadamw.named_leaves(m)) for m in (step, on_ref))
    over = total = 0
    for n, st in params.items():
        assert np.abs(_np(same[n]) - _np(want_ref[n])).max() <= TOL, n
        d = np.abs(_np(st) - _np(want[n]))
        assert d.max() <= UPDATE_WORST * LR, (n, d.max() / LR)
        over += int((d > TOL).sum())
        total += d.size
    assert over <= total // 10_000, (over, total)


def test_train_cell_reads_pieces_and_equals_the_direct_step(monkeypatch):
    """``_lm_cell`` marks a dense config's train arguments piecewise:
    ``Cell.jitted`` over the placed real arguments runs the partitioned
    step (equal bits to calling it directly) and gathers nothing."""
    _patch_registry(monkeypatch, dtype=torch.float32)
    mesh = _mesh((2, 2))
    cell = specs.make_cell("smollm-135m", "train_4k", mesh)
    assert cell.piecewise == (0, 1, 2)
    tcfg = tbase.get("smollm-135m").full()
    opt = tadamw.AdamW(lr=1e-4)
    d = specs.LM_SHAPE_DEFS["train_4k"]
    tokens, targets = _tokens(tcfg.vocab, (d["batch"], d["seq"]))
    batch = {"targets": torch.as_tensor(targets),
             "tokens": torch.as_tensor(tokens)}
    model = TT.LMParams(tcfg, device="cpu")
    a, b = copy.deepcopy(model), copy.deepcopy(model)
    placed = cell.place((a, opt.init(a), batch))
    pa, _, out = cell.jitted()(*placed)
    with sh.use_mesh_rules(mesh, cell.rules):
        pb = TS.place_params(b)
        _, _, ref = tsteps.lm_train_step_sharded(tcfg, opt)(
            pb, _placed_state(opt, b, mesh), batch)
    assert torch.equal(out["loss"], ref["loss"])
    for n, st in pa.items():
        assert torch.equal(st.gather(), pb[n].gather()), n


# ---------------------------------------------------------- prefill, decode


def _decode_rules(batch):
    return specs.lm_rules("decode", batch)


@pytest.mark.parametrize("batch", [B, 1])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_on_mesh_equal_reference(arch, shape, batch):
    """The partitioned prefill of B rows (logits, and the cache gathered
    from its pieces, placed (batch, kv_seq over "model")), then its first
    ``batch`` rows' cache padded by 4 and placed by the decode rules, and
    three partitioned decode steps on the reference's greedy tokens:
    their logits (placed (batch, vocab)) and the cache after them, each
    within TOL of the reference's run on ``batch`` rows. (Prefill takes a
    batch that splits over the data axes, as the prefill cells' does.)"""
    _, tcfg = _cfgs(arch)
    mesh = _mesh(shape)
    ref, fed = _ref_serve(arch, batch)
    tokens = _tokens(tcfg.vocab)[0]
    params = TS.place_params(_model(arch), mesh)
    with sh.use_mesh_rules(mesh, specs.lm_rules("prefill", B)):
        logits, cache = TS.prefill(tcfg, params, tokens)
    assert cache["len"] == S
    assert cache["k"].sharding.spec[2] == ("model",)
    k0, v0 = (cache[n].gather()[:, :batch] for n in "kv")
    assert _rel(_np(logits)[:batch], ref["prefill"]) <= TOL
    assert _rel(_np(k0), ref["k0"]) <= TOL
    assert _rel(_np(v0), ref["v0"]) <= TOL
    rules = _decode_rules(batch)
    with sh.use_mesh_rules(mesh, rules):
        padded = TT.pad_cache({"k": k0, "v": v0, "len": S}, S + 4)
        names = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        spec = sh.spec_for(tuple(padded["k"].shape), names, mesh)
        cache = {"k": sh.place(padded["k"], spec, mesh),
                 "v": sh.place(padded["v"], spec, mesh), "len": S}
        for i, token in enumerate(fed):
            logits, cache = TS.decode_step(tcfg, params, cache,
                                           torch.tensor(token))
            assert logits.sharding.spec[1] == ("model",)
            assert _rel(_np(logits), ref[f"decode{i}"]) <= TOL, i
    assert cache["len"] == S + 3
    assert _rel(_np(cache["k"]), ref["k"]) <= TOL
    assert _rel(_np(cache["v"]), ref["v"]) <= TOL


def test_partitioned_decode_refuses_a_full_cache():
    _, tcfg = _cfgs("smollm-135m")
    mesh = _mesh((2, 2))
    params = TS.place_params(_model("smollm-135m"), mesh)
    with sh.use_mesh_rules(mesh, _decode_rules(B)):
        shape = (tcfg.n_layers, B, 8, tcfg.n_kv_heads, tcfg.d_head)
        spec = sh.spec_for(shape, ("layers", "batch", "kv_seq", "kv_heads",
                                   "head_dim"), mesh)
        cache = {n: sh.place(torch.zeros(shape), spec, mesh) for n in "kv"}
        with pytest.raises(ValueError, match="full"):
            TS.decode_step(tcfg, params, dict(cache, len=8),
                           torch.zeros(B, dtype=torch.int32))


def test_bf16_whole_model_on_mesh_within_ulps(monkeypatch):
    """smollm-135m in bf16 on (2, 2): the loss (VOCAB_SLICE_SMOKE rows a
    slice) and prefill's logits within BF16_OUT ulps and each leaf's
    gradient within BF16_GRAD ulps (of max |ref|) of the reference's own
    bf16 run; the cache's dtype bf16."""
    monkeypatch.setattr(TS, "VOCAB_SLICE", VOCAB_SLICE_SMOKE)
    arch = "smollm-135m"
    _, tcfg = _cfgs(arch, "bfloat16")
    mesh = _mesh((2, 2))
    tokens, targets = _tokens(tcfg.vocab)
    ref_loss, ref_grads = _ref_train(arch, "bfloat16")
    ref, _ = _ref_serve(arch, B, "bfloat16")
    params = TS.place_params(_model(arch, "bfloat16"), mesh)
    with sh.use_mesh_rules(mesh):
        loss, grads = TS.value_and_grad(tcfg, params, tokens, targets)
        assert _rel(float(loss), ref_loss) <= BF16_OUT * BF16_ULP
        for n, st in params.items():
            err = _rel(_assemble(st, grads[n]), ref_grads[n])
            assert err <= BF16_GRAD * BF16_ULP, (n, err / BF16_ULP)
    with sh.use_mesh_rules(mesh, specs.lm_rules("prefill", B)):
        logits, cache = TS.prefill(tcfg, params, tokens)
    assert cache["k"].gather().dtype == torch.bfloat16
    assert _rel(_np(logits), ref["prefill"]) <= BF16_OUT * BF16_ULP
    assert _rel(_np(cache["k"]), ref["k0"]) <= BF16_OUT * BF16_ULP


# ----------------------------------------------------------------- dry run

SMALL_SHAPES = {"train_4k": dict(kind="train", seq=256, batch=16),
                "prefill_32k": dict(kind="prefill", seq=256, batch=4),
                "decode_32k": dict(kind="decode", seq=256, batch=4),
                "long_500k": dict(kind="decode", seq=1024, batch=1)}
# the class check traces every position: smaller still (chunks of 16)
TINY_SHAPES = {"train_4k": dict(kind="train", seq=64, batch=4),
               "prefill_32k": dict(kind="prefill", seq=64, batch=4),
               "decode_32k": dict(kind="decode", seq=64, batch=4),
               "long_500k": dict(kind="decode", seq=128, batch=1)}


def _patch_registry(monkeypatch, dtype=torch.bfloat16, shapes=None,
                    chunk=64):
    """The dense archs' ``full()`` replaced by their smoke configs (in
    ``dtype``, attn_chunk = loss_chunk = ``chunk``) and the LM shapes by
    small ones (``shapes``, SMALL_SHAPES when None)."""
    for arch in DENSE:
        spec = tbase.get(arch)
        small = dataclasses.replace(spec.smoke(), dtype=dtype,
                                    attn_chunk=chunk, loss_chunk=chunk)
        monkeypatch.setitem(tbase._REGISTRY, arch, dataclasses.replace(
            spec, full=lambda small=small: small))
    monkeypatch.setattr(specs, "LM_SHAPE_DEFS", shapes or SMALL_SHAPES)


def _fake_mesh(shape=(4, 4)):
    return make_debug_mesh(shape, devices=dryrun.fake_devices(
        int(np.prod(shape))))


def _gathered(cell, arch):
    """The same cell on the gathered path: the unpartitioned step, every
    argument gathered to the mesh's first device."""
    cfg = tbase.get(arch).full()
    kind = specs.LM_SHAPE_DEFS[cell.shape_name]["kind"]
    fn = {"train": lambda: tsteps.lm_train_step(cfg, tadamw.AdamW(lr=1e-4)),
          "prefill": lambda: tsteps.lm_prefill_step(cfg),
          "decode": lambda: tsteps.lm_decode_step(cfg)}[kind]()
    return dataclasses.replace(cell, fn=fn, piecewise=())


@pytest.mark.parametrize("shape_name", list(SMALL_SHAPES))
def test_dry_run_reads_pieces_and_gathers_nothing(monkeypatch, shape_name):
    """On a fake (4, 4) mesh: the dense cell's walk has no "gather"
    collective and its argument bytes equal the gathered path's; train's
    busiest-device peak is under 1/4 of the gathered path's and its FLOPs
    at most twice the gathered FLOPs over the 16 devices; decode gathers
    no weight over the model axis."""
    _patch_registry(monkeypatch)
    arch = "qwen3-14b"
    mesh = _fake_mesh()
    cell = specs.make_cell(arch, shape_name, mesh)
    walk, _ = dryrun.trace_cell(cell)
    old, _ = dryrun.trace_cell(_gathered(cell, arch))
    assert "gather" not in walk.coll_by_op
    assert "gather" in old.coll_by_op
    assert walk.arg_bytes == old.arg_bytes
    kind = SMALL_SHAPES[shape_name]["kind"]
    if kind == "train":
        assert walk.peak_bytes < old.peak_bytes / 4
    if kind in ("train", "prefill"):
        assert walk.flops <= 2 * old.flops / 16
    if kind == "decode":
        weights = re.compile(r"^(blocks/\w+|embed)@.*model")
        moved = [r.op for r in walk.records
                 if r.kind == "all-gather" and weights.match(r.op)]
        assert not moved, moved


@pytest.mark.parametrize("shape_name", list(TINY_SHAPES))
def test_dry_run_classes_give_the_full_trace_record(monkeypatch,
                                                    shape_name):
    """The dry run traces the first and the last position of each class
    of equal positions; on a fake (2, 4) mesh its record equals the
    trace of every position's program (t_lower_s and n_ops aside: they
    count the work of the trace)."""
    _patch_registry(monkeypatch, shapes=TINY_SHAPES, chunk=16)
    mesh = _fake_mesh((2, 4))
    short = dryrun.run_cell("smollm-135m", shape_name, mesh=mesh,
                            verbose=False)
    with C.every_position():
        full = dryrun.run_cell("smollm-135m", shape_name, mesh=mesh,
                               verbose=False)
    assert short["n_ops"] < full["n_ops"]
    for rec in (short, full):
        rec.pop("t_lower_s")
        rec.pop("n_ops")
    assert short == full


def test_dry_run_on_the_last_fake_devices(monkeypatch):
    """The 512th fake device is "lazy" with no index (torch keeps it in 8
    bits): a train cell on the last two still traces, its AdamW
    constants fake like the rest and its checkpoints looking up no
    device module for "lazy"."""
    _patch_registry(monkeypatch, shapes=TINY_SHAPES, chunk=16)
    mesh = make_debug_mesh((1, 2), devices=dryrun.fake_devices(512)[-2:])
    rec = dryrun.run_cell("smollm-135m", "train_4k", mesh=mesh,
                          verbose=False)
    kinds = {part.split(":")[0] for part in rec["collectives"].split()}
    assert rec["ok"] and "gather" not in kinds and "all-gather" in kinds

