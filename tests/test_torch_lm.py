"""The port's LM stack held against the JAX reference on the CPU, at
``smoke()`` sizes: the layers, flash attention's output and q/k/v
gradients on ``tests/test_kernels.py``'s sweep, dense, chunked and
decode attention, the MoE layer (with and without tokens dropped by capacity,
and with tied router scores), forward, loss and every leaf's gradient
for the five configs, prefill and decode through a padded cache, three
train steps against the reference's jitted steps, ``TokenStream`` and
``host_slice``, the configs and shape tables, checkpoints across the two
packages, the training CLI, and that the new modules import neither jax
nor the reference package.

Parameters. The reference's ``init_params``, with wq, wk and wv
rescaled so that their fan_in is d_model (``_conditioned``), and the same
arrays carried into both packages by ``convert.lm_params_from_jax``. The reference's own init takes fan_in
from the head axis (ROADMAP.md §3): its attention scores then have a
standard deviation of tens, the softmax is near one-hot, and a whole
model amplifies float32 rounding by orders of magnitude, so no tight
check could be made on it. The rescaled model is well-conditioned.

Tolerances. float32: TOL = 1e-5 of max |out| and of each leaf's max
|g|, for a single layer and for a whole model alike (reduction order
only; measured at most 3.4e-6 over the five configs). bf16 is held
against the reference's own bf16 run, in units of BF16_ULP = 2^-7 of
max |out| (one bf16 ulp of a value whose significand is 1).

* One layer (flash, dense, chunked and decode attention; RMSNorm):
  outputs and gradients within one ulp; outputs also (``_hold_layer``)
  with equal bits on all but BF16_FLIPS = 1 % of the entries. The bf16
  attention cases scale q by HOT, so that the scores have a standard
  deviation of about 32 and a score's bf16 rounding moves its softmax
  weight by percents. There the port's outputs equal the reference's
  bit for bit; the q gradients, each a float32 sum over the sequence
  rounded once, differ in the last bit in 1-5 % of their entries. A
  score formed in float32 where the reference forms it in bf16 changes
  the bits of 12-53 % of decode attention's entries; flash attention's
  q, k, v taken to float32 only after the product fails every flash
  case.
* A whole model: outputs (hidden states, loss, aux, prefill and decode
  logits, cache contents) within BF16_OUT = 4 ulps, each leaf's
  gradient within BF16_GRAD = 8. Both packages round to 8 bits at the
  same points but not always the same way (XLA keeps fused elementwise
  chains in float32): measured at most 3.0 and 4.5 ulps over the five
  configs. These checks catch a rounding point that moves the whole
  model (the experts' products taken in float32 do); a softmax's
  rounding is held by the layer tests, since at this conditioning it
  moves a whole model by less than an ulp.

Parameters after train steps are held in units of lr, as
``tests/test_torch_train.py`` holds xDeepFM.
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

from repro.configs import base as rbase
from repro.data import pipeline as rpipeline
from repro.launch import specs as rspecs
from repro.models import flash_attention as RF
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.optim import adamw as radamw
from repro.train import checkpoint as rckpt
from repro.train import steps as rsteps
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import specs as tspecs
from repro_torch.models import flash_attention as TF
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import value_and_grad
from torch_cases import condition_lm

ARCHS = ("smollm-135m", "gemma3-1b", "qwen3-14b", "mixtral-8x22b",
         "llama4-scout-17b-a16e")
DENSE = ARCHS[:3]
TOL = 1e-5          # of max |out| or of a leaf's max |g|: float32 order
BF16_ULP = 2.0 ** -7   # of max |out|: bf16's spacing at a significand of 1
BF16_OUT = 4        # bf16 ulps: outputs, logits, caches
BF16_GRAD = 8       # bf16 ulps: each leaf's gradient
HOT = 32.0          # q's scale in the attention tests: scores of std ~32
LR_WORST = 0.25     # of lr: a parameter after train steps, at most
DTYPES = {"float32": (TOL, TOL),    # a whole model: (outputs, gradients)
          "bfloat16": (BF16_OUT * BF16_ULP, BF16_GRAD * BF16_ULP)}
BF16_FLIPS = 0.01   # one bf16 layer: the share of entries whose bits differ
ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"
NEW_MODULES = ("models/transformer.py", "models/flash_attention.py",
               "models/moe.py", "models/layers.py", "configs/base.py",
               "configs/smollm_135m.py", "configs/gemma3_1b.py",
               "configs/qwen3_14b.py", "configs/mixtral_8x22b.py",
               "configs/llama4_scout_17b_a16e.py", "data/pipeline.py",
               "launch/specs.py", "train/steps.py", "convert.py",
               "launch/train.py")
B, S = 2, 16        # S > attn_chunk (8) and a multiple of it: flash path


def _cfgs(arch: str, dtype: str = "float32"):
    r, t = rbase.get(arch).smoke(), tbase.get(arch).smoke()
    return (dataclasses.replace(r, dtype=getattr(jnp, dtype)),
            dataclasses.replace(t, dtype=getattr(torch, dtype)))


def _conditioned(rcfg, params):
    """``params`` with wq scaled by sqrt(H / d) and wk, wv by sqrt(K / d):
    fan_in d_model where ``dense_init`` takes the head count."""
    blocks, d = dict(params["blocks"]), rcfg.d_model
    for name, heads in (("wq", rcfg.n_heads), ("wk", rcfg.n_kv_heads),
                        ("wv", rcfg.n_kv_heads)):
        blocks[name] = blocks[name] * np.float32(np.sqrt(heads / d))
    return {**params, "blocks": blocks}


def _params(rcfg, tcfg, seed: int = 0):
    """(the conditioned reference parameters, the port's copy of them)."""
    params = _conditioned(rcfg, RT.init_params(rcfg, jr.PRNGKey(seed)))
    model = convert.lm_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, model


def _tokens(vocab: int, shape=(B, S), seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def _names(tree) -> dict:
    names, leaves, _ = rckpt._flatten(tree)
    return {n: np.asarray(v, np.float32) for n, v in zip(names, leaves)}


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(float(np.abs(ref).max()), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _hold_layer(got: torch.Tensor, ref, name: str = "",
                bits: bool = True) -> None:
    """One layer's result against the reference's: float32 within TOL
    of max |ref|; bf16 within one ulp (BF16_ULP of max |ref|) and, with
    ``bits``, with equal bits on all but BF16_FLIPS of the entries."""
    g, r = _np(got), np.asarray(ref, np.float32)
    assert g.shape == r.shape, name
    if got.dtype == torch.float32:
        assert _rel(g, r) <= TOL, (name, _rel(g, r))
        return
    assert _rel(g, r) <= BF16_ULP, (name, _rel(g, r) / BF16_ULP)
    assert not bits or (g != r).mean() <= BF16_FLIPS, (name, (g != r).mean())


def _hold(got: dict, ref: dict, tol: float, grad_tol: float = None) -> None:
    """Each output within ``tol`` of its max |ref|; a leaf's gradient
    (a name with a '/', or embed, ln_f) within ``grad_tol``."""
    assert got.keys() == ref.keys()
    for n, r in ref.items():
        leaf = "/" in n or n in ("embed", "ln_f")
        limit = grad_tol if leaf and grad_tol is not None else tol
        err = _rel(got[n], r)
        assert err <= limit, (n, err, limit)


# ------------------------------------------------------------- layers


def test_rms_norm_and_rope_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32) * 3
    scale = rng.normal(size=8).astype(np.float32)
    pos = np.stack([np.arange(5), 32_760 + np.arange(5)]).astype(np.int32)
    np.testing.assert_allclose(
        _np(TL.rms_norm(torch.tensor(x), torch.tensor(scale))),
        np.asarray(RL.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = TL.rms_norm(torch.tensor(x).to(torch.bfloat16), torch.tensor(scale))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(RL.rms_norm(xb, jnp.asarray(scale)), np.float32)
    # one bf16 ulp: the float32 sums round to the same 8 bits but at a tie
    assert np.abs(_np(got) - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    r = np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos)))
    t = _np(TL.rope(torch.tensor(x), torch.tensor(pos)))
    # sin / cos of angles up to 3.3e4 rad: float32 libraries agree to
    # a few ulps of the angle
    assert _rel(t, r) <= TOL
    zero = TL.rms_norm(torch.tensor(x), torch.zeros(8))
    np.testing.assert_allclose(_np(zero), np.asarray(RL.rms_norm(
        jnp.asarray(x), jnp.zeros(8))), rtol=1e-6, atol=1e-6)


def test_swiglu_and_cross_entropy_equal_reference():
    rng = np.random.default_rng(1)
    x, wg, wu, wd = (rng.normal(size=s).astype(np.float32) for s in
                     ((6, 4), (4, 10), (4, 10), (10, 4)))
    np.testing.assert_allclose(
        _np(TL.swiglu(*map(torch.tensor, (x, wg, wu, wd)))),
        np.asarray(RL.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(                 # sigmoid: an ulp apart
        _np(TL.silu(torch.tensor(x))), np.asarray(RL.silu(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        r = float(RL.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        t = float(TL.softmax_cross_entropy(
            torch.tensor(logits), torch.tensor(labels),
            None if m is None else torch.tensor(m)))
        assert abs(t - r) <= 1e-6 * abs(r)


# ----------------------------------------------------------- attention


FLASH_CASES = [(32, 8, 0, 1.0), (64, 16, 12, 0.0), (32, 32, 4, 1.0),
               (48, 16, 0, 1.0), (48, 16, 20, 0.0)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S_,chunk,window,isg", FLASH_CASES)
def test_flash_attention_equals_reference(S_, chunk, window, isg, dtype):
    """``tests/test_kernels.py:66``'s sweep, plus a window wider than a
    chunk: the output and the q / k / v gradients under one random
    cotangent, against ``jax.vjp`` of the reference's custom VJP, by
    ``_hold_layer``, the bf16 cases at hot scores (q x HOT). Both take
    q, k, v to float32 before the product."""
    rng = np.random.default_rng(S_ + window)
    q, k, v, ct = (rng.normal(size=(2, S_, 3, 8)).astype(np.float32)
                   for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        q = q * np.float32(HOT)

    @jax.jit
    def ref(a, b, c, g):
        out, vjp = jax.vjp(lambda a, b, c: RF.flash_attention(
            a, b, c, jnp.float32(isg), window, chunk), a, b, c)
        return out, vjp(g)

    out, r_grads = ref(*(jnp.asarray(a, jdt) for a in (q, k, v, ct)))
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    got = TF.flash_attention(tq, tk, tv, isg, window, chunk)
    assert got.dtype == tdt
    t_grads = torch.autograd.grad(got, (tq, tk, tv),
                                  torch.tensor(ct).to(tdt))
    _hold_layer(got, out, "out")
    for name, g, r in zip("qkv", t_grads, r_grads):
        _hold_layer(g, r, name, bits=False)


def test_flash_attention_saves_only_linear_residuals():
    """What the forward keeps for the backward: q, k, v, out, m and l,
    none of them (S, S) or (S, chunk) in size."""
    S_, chunk = 64, 16
    saved = []
    q, k, v = (torch.randn(1, S_, 2, 8, requires_grad=True)
               for _ in range(3))
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        TF.flash_attention(q, k, v, 0.0, 24, chunk)
    assert sorted(saved) == sorted([(1, S_, 2, 8)] * 4 + [(1, 2, S_)] * 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_global", [False, True])
@pytest.mark.parametrize("kind", ["dense", "chunked"])
def test_dense_and_chunked_attention_equal_reference(kind, is_global, dtype):
    """GQA (4 heads over 2 KV heads) with a window of 8 over S = 24,
    local and global, against the reference's function of the same
    name: output and the q / k / v gradients by ``_hold_layer``, the
    bf16 cases at hot scores (q x HOT). The dense scores are formed in
    the dtype and then taken to float32, in both."""
    rcfg, tcfg = _cfgs("mixtral-8x22b", dtype)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
            for _ in range(2))
    ct = rng.normal(size=q.shape).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        q = q * np.float32(HOT)
    rf, tf = getattr(RT, f"{kind}_attention"), getattr(TT, f"{kind}_attention")
    out, vjp = jax.vjp(lambda a, b, c: rf(rcfg, a, b, c, jnp.asarray(pos),
                                          jnp.asarray(pos),
                                          jnp.bool_(is_global)),
                       *(jnp.asarray(a, jdt) for a in (q, k, v)))
    r_grads = vjp(jnp.asarray(ct, out.dtype))
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    got = tf(tcfg, tq, tk, tv, torch.tensor(pos), torch.tensor(pos),
             is_global)
    assert got.dtype == tdt
    t_grads = torch.autograd.grad(got, (tq, tk, tv),
                                  torch.tensor(ct).to(got.dtype))
    _hold_layer(got, out, "out")
    for name, g, r in zip("qkv", t_grads, r_grads):
        _hold_layer(g, r, name, bits=False)


# ----------------------------------------------------------------- MoE


MOE_CASES = {"no_drop": (2, 4.0, False), "drop": (2, 0.5, False),
             "ties": (2, 1.25, True), "top1_drop": (1, 0.6, False)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_equals_reference(case):
    """``moe_ffn``'s output, aux loss and the gradients of x, the router
    and the three expert weights, against the reference's local path:
    with capacity to spare, with tokens dropped (cf < 1), with two
    experts' router columns equal (every token's scores tie), and
    top-1. The top k of a tie goes to the lower expert in both."""
    k, cf, ties = MOE_CASES[case]
    T, d, f, E = 40, 12, 20, 4
    rng = np.random.default_rng(5)
    x = rng.normal(size=(T, d)).astype(np.float32)
    router = rng.normal(size=(d, E)).astype(np.float32)
    if ties:
        router[:, 2] = router[:, 1]
    wg, wu = (rng.normal(size=(E, d, f)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.normal(size=(E, f, d)).astype(np.float32) * 0.3
    ct = rng.normal(size=(T, d)).astype(np.float32)
    args = (x, router, wg, wu, wd)

    def r_fn(*a):
        y, aux = RM.moe_ffn(*a, k, cf)
        return jnp.sum(y * ct) + 3.0 * aux, (y, aux)

    (_, (y, aux)), r_grads = jax.jit(jax.value_and_grad(
        r_fn, argnums=tuple(range(5)), has_aux=True))(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    ty, taux = TM.moe_ffn(*ts, k, cf)
    t_grads = torch.autograd.grad((ty * torch.tensor(ct)).sum()
                                  + 3.0 * taux, ts)
    assert _rel(_np(ty), y) <= TOL
    assert abs(taux.item() - float(aux)) <= TOL * abs(float(aux))
    for name, g, r in zip(("x", "router", "w_gate", "w_up", "w_down"),
                          t_grads, r_grads):
        assert _rel(_np(g), r) <= TOL, name
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1)
    _, r_ids = jax.lax.top_k(probs, k)
    _, t_ids = TM._top_k(torch.softmax(torch.tensor(x) @ torch.tensor(router),
                                       -1), k)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(r_ids))
    counts = np.bincount(np.asarray(r_ids).ravel(), minlength=E)
    C = int(np.ceil(T * k / E * cf))
    if case != "ties":
        assert (counts.max() > C) == (case in ("drop", "top1_drop"))
    if ties:     # expert 2 is chosen only after its twin, expert 1
        ids = np.asarray(r_ids)
        with2 = (ids == 2).any(axis=1)
        assert with2.any() and (ids[with2, 0] == 1).all()


def test_top_k_breaks_ties_to_the_lower_id():
    a = np.array([[1.0, 2.0, 2.0, 0.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(a), 2)
    tv, ti = TM._top_k(torch.tensor(a), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    assert ti.tolist() == [[1, 2], [0, 1]]


# ------------------------------------------- whole models vs reference


def _ref_outputs(rcfg, params, tokens, targets):
    @jax.jit
    def both(p):
        return (RT.forward(rcfg, p, jnp.asarray(tokens)),
                jax.value_and_grad(lambda q: RT.lm_loss(
                    rcfg, q, jnp.asarray(tokens), jnp.asarray(targets)))(p))

    (x, aux), (loss, grads) = both(params)
    return {"x": np.asarray(x, np.float32), "aux": float(aux),
            "loss": float(loss), **_names(grads)}


def _port_outputs(tcfg, model, tokens, targets):
    with torch.no_grad():
        x, aux = TT.forward(tcfg, model, tokens)
    loss, grads = value_and_grad(
        lambda p, b: TT.lm_loss(tcfg, p, b["tokens"], b["targets"]), model,
        {"tokens": tokens, "targets": targets})
    return {"x": _np(x), "aux": float(aux), "loss": float(loss),
            **{n: _np(g) for n, g in grads.items()}}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_equal_reference(arch, dtype):
    """forward's hidden states and aux, ``lm_loss`` and every leaf's
    gradient, in float32 within TOL and in the config's bf16 within
    BF16_OUT (outputs) and BF16_GRAD (gradients) bf16 ulps of the
    reference's own bf16 run (module docstring)."""
    rcfg, tcfg = _cfgs(arch, dtype)
    params, model = _params(rcfg, tcfg)
    tokens, targets = _tokens(rcfg.vocab)
    ref = _ref_outputs(rcfg, params, tokens, targets)
    got = _port_outputs(tcfg, model, tokens, targets)
    if not tcfg.is_moe:
        assert got["aux"] == ref["aux"] == 0.0
        ref["aux"] = got["aux"] = 1.0
    _hold(got, ref, *DTYPES[dtype])
    with torch.no_grad():
        x = TT.forward(tcfg, model, tokens)[0]
    assert x.dtype == getattr(torch, dtype)


# ------------------------------------------------------ prefill, decode


def _ref_pad(cache, extra):
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {"k": jnp.pad(cache["k"], pad), "v": jnp.pad(cache["v"], pad),
            "len": cache["len"]}


def _serve_reference(rcfg, params, tokens):
    """(the reference's prefill logits, three greedy decode steps' logits
    through the cache padded by 4, and the cache, as numpy; its fed
    tokens; its final len)."""
    logits, cache = jax.jit(lambda p, t: RT.prefill(rcfg, p, t))(
        params, jnp.asarray(tokens))
    decode = jax.jit(lambda p, c, t: RT.decode_step(rcfg, p, c, t))
    out = {"prefill": np.asarray(logits)}
    cache = _ref_pad(cache, 4)
    fed = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for i in range(3):
        logits, cache = decode(params, cache, fed[-1])
        out[f"decode{i}"] = np.asarray(logits)
        fed.append(jnp.argmax(logits, -1).astype(jnp.int32))
    out["k"], out["v"] = (np.asarray(cache[n], np.float32) for n in "kv")
    return out, [np.asarray(t) for t in fed[:3]], int(cache["len"])


def _serve_port(tcfg, model, tokens, fed):
    """The same through the port's prefill and decode, fed ``fed``."""
    logits, cache = TT.prefill(tcfg, model, tokens)
    assert cache["len"] == tokens.shape[1] == cache["k"].shape[2]
    assert cache["k"].dtype == tcfg.dtype
    out = {"prefill": _np(logits)}
    cache = TT.pad_cache(cache, tokens.shape[1] + 4)
    k_tensor = cache["k"]
    for i, token in enumerate(fed):
        logits, cache = TT.decode_step(tcfg, model, cache,
                                       torch.tensor(token))
        out[f"decode{i}"] = _np(logits)
    assert cache["k"] is k_tensor           # written in place
    out["k"], out["v"] = _np(cache["k"]), _np(cache["v"])
    return out, cache["len"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch, dtype):
    """``prefill`` over 16 tokens (the flash path), the cache padded by
    4, then three ``decode_step``s on the reference's greedy tokens:
    each step's logits and the cache's contents within TOL (float32) or
    BF16_OUT bf16 ulps of the reference's bf16 run, the lengths equal,
    and the port's cache written in place."""
    rcfg, tcfg = _cfgs(arch, dtype)
    params, model = _params(rcfg, tcfg)
    tokens, _ = _tokens(rcfg.vocab)
    ref, fed, ref_len = _serve_reference(rcfg, params, tokens)
    got, got_len = _serve_port(tcfg, model, tokens, fed)
    assert got_len == ref_len == S + 3
    _hold(got, ref, DTYPES[dtype][0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("is_global", [False, True])
def test_decode_attention_equals_reference(is_global, dtype):
    """Decode's attention, 16 queries at position 30 over a cache of 40
    slots (those past 30 hold noise, and a window of 8 where local),
    against the reference's ``dense_attention`` at that query position:
    the function the reference's ``decode_step`` computes inline (scores
    formed in the dtype, then the float32 softmax). ``_hold_layer``,
    the bf16 case at hot scores (q x HOT)."""
    rcfg, tcfg = _cfgs("mixtral-8x22b", dtype)
    rng = np.random.default_rng(7)
    q = rng.normal(size=(16, 1, 4, 16)).astype(np.float32)
    ck, cv = (rng.normal(size=(16, 40, 2, 16)).astype(np.float32)
              for _ in range(2))
    pos, k_pos = 30, np.arange(40, dtype=np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        q = q * np.float32(HOT)
    ref = RT.dense_attention(rcfg, *(jnp.asarray(a, jdt) for a in (q, ck, cv)),
                             jnp.asarray([pos], jnp.int32),
                             jnp.asarray(k_pos), jnp.bool_(is_global))
    valid = torch.tensor(k_pos <= pos)
    if not is_global:
        valid &= torch.tensor(k_pos > pos - tcfg.window)
    got = TT._decode_attention(tcfg, *(torch.tensor(a).to(tdt)
                                       for a in (q, ck, cv)), valid)
    assert got.dtype == tdt
    _hold_layer(got, ref)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x22b"])
def test_decode_equals_forward_in_float32(arch):
    """Decoding one token through the padded cache gives the logits of
    ``forward`` over the prompt plus that token, within 1e-4 of max
    |logit| (float32, reduction order only; the same check
    ``chip_smoke.py`` makes on the card at full width, on the same
    conditioned weights). Windowed
    configs, with a prompt longer than the window; the MoE one at
    capacity_factor E / k, where no assignment is dropped (at its own
    factor the forward over the prompt may drop the last token's
    assignments, which a one-token decode step keeps)."""
    _, tcfg = _cfgs(arch)
    if tcfg.is_moe:
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.moe_experts / tcfg.moe_top_k)
    model = TT.init_params(tcfg, torch.Generator().manual_seed(3))
    condition_lm(tcfg, model)
    tokens, _ = _tokens(tcfg.vocab, (2, 23), seed=4)
    logits, cache = TT.prefill(tcfg, model, tokens)
    nxt = logits.argmax(-1)
    dec, _ = TT.decode_step(tcfg, model, TT.pad_cache(cache, 32), nxt)
    with torch.no_grad():
        x, _ = TT.forward(tcfg, model, np.concatenate(
            [tokens, nxt[:, None].numpy().astype(np.int32)], 1))
        ref = x[:, -1] @ model.embed.T
    assert _rel(_np(dec), _np(ref)) <= 1e-4


def test_full_cache_reference_clamps_port_raises():
    """At a full cache (len == S) the reference's ``dynamic_update_slice``
    clamps the write to slot S - 1 and every key stays valid; the port
    raises ValueError and leaves the cache as it was (ROADMAP.md §3)."""
    rcfg, tcfg = _cfgs("qwen3-14b")
    params, model = _params(rcfg, tcfg)
    tokens, _ = _tokens(rcfg.vocab, (2, 6))
    logits, cache = jax.jit(lambda p, t: RT.prefill(rcfg, p, t))(
        params, jnp.asarray(tokens))
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    _, full = jax.jit(lambda p, c, t: RT.decode_step(rcfg, p, c, t))(
        params, cache, nxt)
    assert int(full["len"]) == 7 and full["k"].shape[2] == 6
    before, after = np.asarray(cache["k"]), np.asarray(full["k"])
    np.testing.assert_array_equal(after[:, :, :5], before[:, :, :5])
    assert not np.array_equal(after[:, :, 5], before[:, :, 5])
    _, tc = TT.prefill(tcfg, model, tokens)
    k0 = tc["k"].clone()
    with pytest.raises(ValueError, match="cache is full"):
        TT.decode_step(tcfg, model, tc, torch.tensor(np.asarray(nxt)))
    assert torch.equal(tc["k"], k0)


def test_loss_chunk_must_divide_the_sequence():
    """The reference CLI's ``--full`` with its default ``--seq 64``: every
    full config's loss_chunk is 512, and the reference's ``lm_loss``
    fails its ``S % loss_chunk`` assertion (here while tracing, with no
    parameter made); the port's raises ValueError naming loss_chunk,
    before its forward pass (ROADMAP.md §3)."""
    for arch in ARCHS:
        assert rbase.get(arch).full().loss_chunk == 512
    rcfg = rbase.get("smollm-135m").full()
    shapes = jax.eval_shape(lambda: RT.init_params(rcfg, jr.PRNGKey(0)))
    toks = jax.ShapeDtypeStruct((8, 64), jnp.int32)
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda p, t: RT.lm_loss(rcfg, p, t, t), shapes, toks)
    tcfg = dataclasses.replace(tbase.get("smollm-135m").smoke(),
                               loss_chunk=512)
    model = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = np.zeros((8, 64), np.int32)
    with pytest.raises(ValueError, match="loss_chunk 512"):
        TT.lm_loss(tcfg, model, toks, toks)


def test_steps_wrap_the_model_functions():
    rcfg, tcfg = _cfgs("llama4-scout-17b-a16e")
    _, model = _params(rcfg, tcfg)
    tokens, _ = _tokens(rcfg.vocab, (2, 10))
    out = tsteps.lm_prefill_step(tcfg)(model, {"tokens": tokens})
    logits, cache = TT.prefill(tcfg, model, tokens)
    assert torch.equal(out["logits"], logits)
    assert torch.equal(out["cache"]["k"], cache["k"])
    nxt = logits.argmax(-1)
    c1, c2 = TT.pad_cache(cache, 12), TT.pad_cache(cache, 12)
    dec = tsteps.lm_decode_step(tcfg)(model, c1, {"token": nxt})
    ref, _ = TT.decode_step(tcfg, model, c2, nxt)
    assert torch.equal(dec["logits"], ref) and dec["cache"]["len"] == 11
    assert torch.equal(c1["v"], c2["v"])


# ---------------------------------------------------------- train steps


@functools.lru_cache(maxsize=None)
def _ref_train_step(arch: str, lr: float = 1e-3):
    """(the reference's AdamW, its jitted ``lm_train_step``) in float32,
    compiled once for the train-step and checkpoint tests."""
    opt = radamw.AdamW(lr=lr)
    return opt, jax.jit(rsteps.lm_train_step(_cfgs(arch)[0], opt))


def _diff_in_lr(got: dict, ref: dict, lr: float):
    """(worst |diff| / lr, entries over 1e-3 lr, total entries)."""
    worst, over, total = 0.0, 0, 0
    for n, r in ref.items():
        d = np.abs(np.asarray(got[n], np.float64) - r) / lr
        worst = max(worst, float(d.max()))
        over += int((d > 1e-3).sum())
        total += d.size
    return worst, over, total


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x22b"])
def test_train_steps_equal_reference_jitted_steps(arch):
    """Three ``lm_train_step`` calls (float32) against the reference's
    jitted step from the same parameters on ``TokenStream`` batches:
    losses within TOL relative; parameters within 1e-3 lr but at most 1
    in 1,000 entries, and all within LR_WORST lr (measured: none over
    at smollm-135m, 21 of 254,784 at mixtral-8x22b, whose expert rows
    with near-zero gradients AdamW's g / (|g| + eps) scales up; the
    worst 0.03 lr)."""
    rcfg, tcfg = _cfgs(arch)
    params, model = _params(rcfg, tcfg)
    stream = rpipeline.TokenStream(rcfg.vocab, B, S, seed=2)
    lr = 1e-3
    (r_opt, r_step), t_opt = _ref_train_step(arch, lr), tadamw.AdamW(lr=lr)
    t_step = tsteps.lm_train_step(tcfg, t_opt)
    r_state, t_state = r_opt.init(params), t_opt.init(model)
    for k in range(3):
        batch = {n: jnp.asarray(v) for n, v in stream.batch_at(k).items()}
        params, r_state, r_m = r_step(params, r_state, batch)
        model, t_state, t_m = t_step(model, t_state, stream.batch_at(k))
        assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= \
            TOL * abs(float(r_m["loss"]))
        worst, over, total = _diff_in_lr(
            {n: _np(p) for n, p in tadamw.named_leaves(model)},
            _names(params), lr)
        assert over <= total // 1000, (k, over, total)
        assert worst <= LR_WORST, (k, worst)
    assert int(t_state.step) == int(r_state.step) == 3


# ------------------------------------------------------- data, configs


def test_token_stream_equal_bits_and_host_slice():
    for kw in (dict(vocab=512, batch=4, seq=16), dict(vocab=49152, batch=3,
                                                      seq=64, seed=5)):
        r, t = rpipeline.TokenStream(**kw), tpipeline.TokenStream(**kw)
        for step in (0, 7):
            a, b = r.batch_at(step), t.batch_at(step)
            assert a.keys() == b.keys()
            for n in a:
                assert a[n].dtype == b[n].dtype == np.int32
                assert np.array_equal(a[n], b[n])
        first = next(iter(t))
        assert np.array_equal(first["tokens"], t.batch_at(0)["tokens"])
    batch = tpipeline.TokenStream(512, 7, 8).batch_at(3)
    for hosts in (1, 2, 3):
        for h in range(hosts):
            a = rpipeline.host_slice(batch, h, hosts)
            b = tpipeline.host_slice(batch, h, hosts)
            assert all(np.array_equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    rs, ts = rbase.get(arch), tbase.get(arch)
    assert (rs.family, rs.shapes, rs.notes) == (ts.family, ts.shapes,
                                               ts.notes) and rs.family == "lm"
    for make in ("full", "smoke"):
        rc, tc = getattr(rs, make)(), getattr(ts, make)()
        r, t = dataclasses.asdict(rc), dataclasses.asdict(tc)
        assert r.pop("dtype") == jnp.bfloat16
        assert t.pop("dtype") == torch.bfloat16
        assert r == t
        assert tc.param_count() == rc.param_count()
        assert tc.active_param_count() == rc.active_param_count()
        assert np.array_equal(tc.layer_is_global(), rc.layer_is_global())
        for d in rspecs.LM_SHAPE_DEFS.values():
            assert tspecs.lm_model_flops(tc, d["kind"], d["batch"],
                                         d["seq"]) == \
                rspecs.lm_model_flops(rc, d["kind"], d["batch"], d["seq"])


def test_shape_tables_equal_reference():
    assert tbase.LM_SHAPES == rbase.LM_SHAPES
    assert tspecs.LM_SHAPE_DEFS == rspecs.LM_SHAPE_DEFS
    assert {a for a, s in tbase.all_archs().items() if s.family == "lm"} \
        == set(ARCHS)
    assert tbase.get("smollm-135m").full().param_count() == 134_515_008


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_the_reference_names_and_shapes(arch):
    rcfg, tcfg = _cfgs(arch)
    ref = _names(RT.init_params(rcfg, jr.PRNGKey(0)))
    own = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    got = {n: tuple(p.shape) for n, p in tadamw.named_leaves(own)}
    assert got == {n: a.shape for n, a in ref.items()}
    # the reference's count leaves out the qk-norm scales
    qk = 2 * tcfg.n_layers * tcfg.d_head if tcfg.qk_norm else 0
    assert sum(p.numel() for p in own.parameters()) == \
        tcfg.param_count() + qk
    assert not any(p.requires_grad for p in own.parameters())
    assert all(p.dtype == torch.float32 for p in own.parameters())
    for n in ("blocks/ln1", "blocks/ln2", "ln_f"):
        assert not dict(tadamw.named_leaves(own))[n].any()
    with pytest.raises(ValueError):
        convert.lm_params_from_jax(tcfg, {"embed": ref["embed"],
                                          "blocks": {}, "ln_f": ref["ln_f"]},
                                   device="cpu")


def test_dense_init_takes_fan_in_from_the_head_axis():
    """The reference scales wq (L, d, H, dh) by 1/sqrt(H) and wk by
    1/sqrt(K), not by 1/sqrt(d) (``layers.dense_init`` takes fan_in from
    the second-to-last axis); the port draws the same distribution
    (ROADMAP.md §3: the random-init LM is ill-conditioned)."""
    rcfg, tcfg = _cfgs("qwen3-14b")
    rcfg = dataclasses.replace(rcfg, d_model=256, n_heads=16, n_kv_heads=4)
    tcfg = dataclasses.replace(tcfg, d_model=256, n_heads=16, n_kv_heads=4)
    ref = _names(jax.jit(lambda k: RT.init_params(rcfg, k))(jr.PRNGKey(0)))
    own = {n: _np(p) for n, p in tadamw.named_leaves(
        TT.init_params(tcfg, torch.Generator().manual_seed(0)))}
    for name, fan_in in (("blocks/wq", 16), ("blocks/wk", 4),
                         ("blocks/wv", 4), ("blocks/w_gate", 256)):
        for tree in (ref, own):
            assert abs(tree[name].std() * np.sqrt(fan_in) - 1) < 0.02, name
    assert abs(ref["embed"].std() / 0.02 - 1) < 0.02
    assert abs(own["embed"].std() / 0.02 - 1) < 0.02


# --------------------------------------------------------- checkpoints


def _trained_pair(arch="mixtral-8x22b"):
    rcfg, tcfg = _cfgs(arch)
    params, model = _params(rcfg, tcfg)
    opt, step = _ref_train_step(arch)
    state = opt.init(params)
    batch = rpipeline.TokenStream(rcfg.vocab, B, S).batch_at(0)
    params, state, _ = step(params, state, {n: jnp.asarray(v)
                                            for n, v in batch.items()})
    return rcfg, params, state, tcfg


def test_reference_lm_checkpoint_restores_in_port_with_equal_bits(tmp_path):
    _, params, state, tcfg = _trained_pair()
    rckpt.save(str(tmp_path), 1, params, state, extra={"cursor": 1})
    fresh = TT.init_params(tcfg, torch.Generator().manual_seed(9))
    p2, o2, mf = tckpt.restore(str(tmp_path), tckpt.latest_step(
        str(tmp_path)), fresh, tadamw.AdamW().init(fresh))
    assert p2 is fresh and mf["extra"] == {"cursor": 1}
    own = dict(tadamw.named_leaves(p2))
    for n, a in _names(params).items():
        assert np.array_equal(own[n].detach().numpy(), a), n
    assert int(o2.step) == int(state.step) == 1
    for field in ("m", "v"):
        for n, a in _names(getattr(state, field)).items():
            assert np.array_equal(getattr(o2, field)[n].numpy(), a), n


def test_port_lm_checkpoint_restores_in_reference_with_equal_bits(tmp_path):
    rcfg, params, state, tcfg = _trained_pair()
    model = convert.lm_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    t_state = convert.adamw_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state), model)
    tckpt.save(str(tmp_path), 5, model, t_state, extra={"cursor": 5})
    blank = RT.init_params(rcfg, jr.PRNGKey(3))
    p2, o2, mf = rckpt.restore(str(tmp_path), 5, blank,
                               radamw.AdamW().init(blank))
    assert mf["extra"] == {"cursor": 5}
    own = dict(tadamw.named_leaves(model))
    for n, a in _names(p2).items():
        assert np.array_equal(a, own[n].detach().numpy()), n
    for field in ("m", "v"):
        for n, a in _names(getattr(o2, field)).items():
            assert np.array_equal(a, getattr(t_state, field)[n].numpy()), n
    assert int(o2.step) == 1


# ---------------------------------------------------- CLI and imports


@pytest.mark.parametrize("module", NEW_MODULES)
def test_lm_modules_import_neither_jax_nor_the_reference(module):
    tree = ast.parse((SRC / module).read_text())
    mods = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
            for a in node.names]
    mods += [node.module for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The training CLI on smollm-135m (smoke, three steps) and with
    ``--full`` at the default ``--seq``, started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    d = tmp_path_factory.mktemp("lm_cli")
    argv = {"smoke": ["--steps", "3", "--ckpt-dir", str(d)],
            "full": ["--full"]}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--device", "cpu", *a], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=d)
        for name, a in argv.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        out[name] = (proc.returncode, stdout, stderr)
    return out, d


def test_train_cli_trains_an_lm(cli_runs):
    """``python -m repro_torch.launch.train --arch smollm-135m --device
    cpu --steps 3`` logs three finite losses and checkpoints."""
    out, d = cli_runs
    rc, stdout, stderr = out["smoke"]
    assert rc == 0, stderr
    lines = [ln for ln in stdout.splitlines() if " loss " in ln]
    assert [ln.split()[2] for ln in lines] == ["0", "1", "2"]
    assert all(np.isfinite(float(ln.split()[4])) for ln in lines)
    assert tckpt.latest_step(str(d)) == 2


def test_train_cli_full_with_the_default_seq_names_loss_chunk(cli_runs):
    rc, stdout, stderr = cli_runs[0]["full"]
    assert rc != 0 and "loss_chunk 512" in stderr and " loss " not in stdout
