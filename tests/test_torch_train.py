"""The port's xDeepFM training path held against the JAX reference on the
CPU, at ``xdeepfm.smoke()`` size or smaller: the loss and every leaf's
gradient, the CIN layer's autograd Function (its plain backward) against
``jax.grad`` of the reference's einsum CIN, AdamW (one update, the norm,
the schedule), the train step, checkpoints across the two packages, the
trainer (restart-resume, gradient accumulation), the elastic plan,
gradient compression, the optimizer-state converter and the training
CLI. Mirrors ``tests/test_checkpoint.py`` case by case.

Inputs come from NumPy seeds and go to both packages; parameters are
the reference's ``init_params``, carried by
``convert.recsys_params_from_jax``.

Tolerances: gradients within 1e-5 of each leaf's max |g| (float32
reduction order); one AdamW update on the same arrays within 1e-6
relative (float32 rounding). Parameters after train steps are held in
units of lr: AdamW's step is ``g / (|g| + eps)`` per entry, so where
float32 order flips the sign of a near-zero gradient entry the two
packages differ by up to 2 lr (the count of such entries is asserted).
"""
import dataclasses
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

from repro.configs import xdeepfm as rxdeepfm
from repro.data import pipeline as rpipeline
from repro.models import recsys as R
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro.train import checkpoint as rckpt
from repro.train import elastic as relastic
from repro.train import steps as rsteps
from repro.train import trainer as rtrainer
from repro_torch import convert
from repro_torch.configs import xdeepfm as txdeepfm
from repro_torch.kernels import cin as tcin
from repro_torch.models import recsys as T
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as telastic
from repro_torch.train import steps as tsteps
from repro_torch.train import trainer as ttrainer

GRAD_TOL = 1e-5    # of each leaf's max |g|: float32 reduction order
UPDATE_RTOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


def _names(tree) -> dict:
    """{checkpoint name: NumPy array} of a reference pytree."""
    names, leaves, _ = rckpt._flatten(tree)
    return {n: np.asarray(v) for n, v in zip(names, leaves)}


def _model():
    rcfg, tcfg = rxdeepfm.smoke(), txdeepfm.smoke()
    params = R.init_params(rcfg, jr.PRNGKey(0))
    model = convert.recsys_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return rcfg, params, tcfg, model


def _batch(rcfg, B=32, mh=True, step=0):
    return rpipeline.RecsysStream(
        rcfg.n_fields, rcfg.vocab_per_field, B,
        multi_hot_fields=rcfg.multi_hot_fields if mh else 0,
        bag_size=rcfg.bag_size, seed=7).batch_at(step)


def _close_per_leaf(got: dict, ref: dict, tol: float) -> None:
    assert got.keys() == ref.keys()
    for n, r in ref.items():
        g = np.asarray(got[n], np.float64)
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max()) / scale
        assert err <= tol, (n, err)


# ------------------------------------------------------------ the loss


@pytest.mark.parametrize("mh", [False, True], ids=["ids", "mh_ids"])
def test_loss_and_grads_equal_reference(mh):
    rcfg, params, tcfg, model = _model()
    batch = _batch(rcfg, mh=mh)
    assert ("mh_ids" in batch) == mh
    loss_r, grads_r = jax.jit(jax.value_and_grad(
        lambda p, b: R.loss_fn(rcfg, p, b)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, grads_t = ttrainer.value_and_grad(
        lambda p, b: T.loss_fn(tcfg, p, b), model, batch)
    assert abs(float(loss_t) - float(loss_r)) <= 1e-6 * abs(float(loss_r))
    _close_per_leaf({n: g.numpy() for n, g in grads_t.items()},
                    _names(grads_r), GRAD_TOL)
    # the embedding rows no id reaches get exact zeros in both
    emb_t = grads_t["tables/embed"].numpy()
    emb_r = _names(grads_r)["tables/embed"]
    assert np.array_equal(emb_t == 0, emb_r == 0)


def test_loss_is_stable_bce():
    """The loss equals torch's own BCE-with-logits on the forward's
    logits, and stays finite at logits far from 0."""
    rcfg, _, tcfg, model = _model()
    batch = _batch(rcfg)
    with torch.no_grad():
        logit = T.forward(tcfg, model, batch)
        got = T.loss_fn(tcfg, model, batch)
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        logit, torch.as_tensor(batch["labels"]).float())
    assert got.dtype == torch.float32
    assert abs(float(got) - float(ref)) <= 1e-6 * float(ref)
    with torch.no_grad():
        model.recsys.bias.fill_(90.0)
        assert torch.isfinite(T.loss_fn(tcfg, model, batch))


def test_init_params_is_the_seeded_module():
    cfg = txdeepfm.smoke()
    a = T.init_params(cfg, torch.Generator().manual_seed(3))
    b = T.XDeepFM(cfg, generator=torch.Generator().manual_seed(3))
    assert isinstance(a, T.XDeepFM)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q) and not p.requires_grad, n
    assert T.init_params(cfg, device="cpu").device.type == "cpu"


# ---------------------------------------------------------- the CIN grad


CIN_CASES = [(8, 4, 3, (5,)), (8, 5, 2, (5,)), (6, 4, 3, (6, 4)),
             (7, 3, 4, (6, 4, 3)), (5, 6, 2, (6, 6, 6))]


@pytest.mark.parametrize("case", CIN_CASES, ids=str)
def test_cin_function_grads_equal_jax_grad(case):
    """The CIN stack through ``CinLayer`` (layer 1's xk is x0: autograd
    adds dx0 and dxk) against ``jax.vjp`` of the reference's einsum
    ``cin`` (``use_kernel=False``), m != h included."""
    B, m, D, hs = case
    rng = np.random.default_rng(B * m + D + len(hs))
    x0 = rng.normal(size=(B, m, D)).astype(np.float32)
    dims = (m,) + hs
    Ws = [(rng.normal(size=(dims[i + 1], dims[i], m)) * 0.3)
          .astype(np.float32) for i in range(len(hs))]
    cot = rng.normal(size=(B, sum(hs))).astype(np.float32)
    @jax.jit
    def ref(x, ws, c):
        out, vjp = jax.vjp(lambda a, b: R.cin(a, b, use_kernel=False), x, ws)
        return out, vjp(c)
    out_r, (gx_r, gw_r) = ref(jnp.asarray(x0), [jnp.asarray(w) for w in Ws],
                              jnp.asarray(cot))
    x0_t = torch.tensor(x0, requires_grad=True)
    Ws_t = [torch.tensor(w, requires_grad=True) for w in Ws]
    out_t = tcin.cin_forward(x0_t, Ws_t)
    assert type(out_t.grad_fn).__name__ == "CatBackward0"
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_r),
                               rtol=2e-5, atol=2e-5 * np.abs(out_r).max())
    grads = torch.autograd.grad(out_t, [x0_t] + Ws_t, torch.tensor(cot))
    refs = [np.asarray(gx_r)] + [np.asarray(g) for g in gw_r]
    _close_per_leaf({i: g.numpy() for i, g in enumerate(grads)},
                    dict(enumerate(refs)), GRAD_TOL)


def test_cin_backward_plain_formulas_equal_jax_vjp():
    """Each of the three formulas alone, x0 != xk, against jax.vjp of
    one reference einsum layer."""
    rng = np.random.default_rng(11)
    B, m, h, hp, D = 6, 4, 5, 3, 2
    x0, xk = (rng.normal(size=(B, n, D)).astype(np.float32) for n in (m, h))
    W = rng.normal(size=(hp, h, m)).astype(np.float32)
    g = rng.normal(size=(B, hp, D)).astype(np.float32)

    def layer(a, b, w):
        return jnp.einsum("bhfd,ihf->bid", jnp.einsum("bhd,bfd->bhfd", b, a),
                          w)
    _, vjp = jax.vjp(layer, jnp.asarray(x0), jnp.asarray(xk), jnp.asarray(W))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    got = tcin.cin_layer_backward_plain(*(torch.as_tensor(a)
                                          for a in (x0, xk, W, g)))
    _close_per_leaf({i: t.numpy() for i, t in enumerate(got)},
                    dict(enumerate(refs)), GRAD_TOL)
    # the wrappers take the same formulas on the CPU, and count nothing
    for fn, ref in zip((tcin.cin_grad_x0, tcin.cin_grad_xk,
                        tcin.cin_grad_w), got):
        assert torch.equal(fn(*(torch.as_tensor(a)
                                for a in (x0, xk, W, g))), ref)
        assert fn.launches == 0


def test_cin_layer_first_layer_sums_both_input_grads():
    rng = np.random.default_rng(4)
    x0 = torch.tensor(rng.normal(size=(5, 3, 2)).astype(np.float32),
                      requires_grad=True)
    W = torch.tensor(rng.normal(size=(4, 3, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(5, 4, 2)).astype(np.float32))
    out = tcin.CinLayer.apply(x0, x0, W)
    (gx,) = torch.autograd.grad(out, [x0], g)
    dx0, dxk, _ = tcin.cin_layer_backward_plain(x0.detach(), x0.detach(),
                                                W, g)
    assert torch.allclose(gx, dx0 + dxk, rtol=1e-6, atol=1e-6)


def test_cin_no_grad_records_nothing():
    rng = np.random.default_rng(2)
    x0 = torch.tensor(rng.normal(size=(4, 3, 2)).astype(np.float32),
                      requires_grad=True)
    W = torch.tensor(rng.normal(size=(2, 3, 3)).astype(np.float32))
    with torch.no_grad():
        assert tcin.cin_layer(x0, x0, W).grad_fn is None
    with torch.inference_mode():
        assert tcin.cin_layer(x0, x0, W).grad_fn is None
    with pytest.raises(ValueError, match="gradient g"):
        tcin.cin_grad_w(x0.detach(), x0.detach(), W, torch.zeros(4, 3, 2))


# ---------------------------------------------------------------- AdamW


def _opt_arrays(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": {"c": (5,)}, "d": [(2,), (2, 2)]}

    def draw(f):
        return jax.tree_util.tree_map(
            lambda s: f(s).astype(np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
    p = draw(lambda s: rng.normal(size=s))
    g = draw(lambda s: rng.normal(size=s) * scale)
    m = draw(lambda s: rng.normal(size=s) * 0.1)
    v = draw(lambda s: rng.uniform(0.01, 1.0, size=s))
    return p, g, m, v


def _port_tree(tree):
    return jax.tree_util.tree_map(torch.tensor, tree)


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("sched", [False, True], ids=["const", "cosine"])
def test_adamw_update_equals_reference(clip, sched):
    p, g, m, v = _opt_arrays(scale=3.0)      # global norm ~ 20: clips
    kw = dict(weight_decay=0.1, grad_clip=clip)
    r_opt = radamw.AdamW(lr=radamw.cosine_schedule(1e-2, 2, 10)
                         if sched else 1e-2, **kw)
    t_opt = tadamw.AdamW(lr=tadamw.cosine_schedule(1e-2, 2, 10)
                         if sched else 1e-2, **kw)
    r_state = radamw.AdamWState(step=jnp.int32(3), m=m, v=v)
    p_r, s_r = r_opt.update(g, r_state, p)
    tp = _port_tree(p)
    t_state = tadamw.AdamWState(
        step=torch.tensor(3, dtype=torch.int32),
        m=dict(_names(m).items()), v=dict(_names(v).items()))
    t_state = t_state._replace(m={n: torch.tensor(a)
                                  for n, a in t_state.m.items()},
                               v={n: torch.tensor(a)
                                  for n, a in t_state.v.items()})
    tg = {n: torch.tensor(a) for n, a in _names(g).items()}
    p_t, s_t = t_opt.update(tg, t_state, tp)
    assert p_t is tp and int(s_t.step) == int(s_r.step) == 4
    for got, ref in ((dict(tadamw.named_leaves(p_t)), _names(p_r)),
                     (s_t.m, _names(s_r.m)), (s_t.v, _names(s_r.v))):
        _close_per_leaf({n: t.numpy() for n, t in got.items()}, ref,
                        UPDATE_RTOL)


def test_adamw_state_is_float32_for_bf16_params():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    st = tadamw.AdamW().init(p)
    assert st.m["w"].dtype == st.v["w"].dtype == torch.float32
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    p2, st2 = tadamw.AdamW().update({"w": torch.ones(3)}, st, p)
    assert p2["w"].dtype == torch.bfloat16 and int(st2.step) == 1


def test_global_norm_and_cosine_schedule_equal_reference():
    p, g, _, _ = _opt_arrays(seed=3)
    r = float(radamw.global_norm(g))
    t = float(tadamw.global_norm(_port_tree(g)))
    assert abs(r - t) <= 1e-6 * r
    r_lr = radamw.cosine_schedule(3e-3, 10, 50)
    t_lr = tadamw.cosine_schedule(3e-3, 10, 50)
    for s in (0, 1, 5, 10, 11, 30, 50, 60):
        a = float(r_lr(jnp.int32(s)))
        b = t_lr(torch.tensor(s, dtype=torch.int32))
        assert b.dtype == torch.float32
        assert abs(a - float(b)) <= 1e-6 * max(abs(a), 1e-12), s


# ------------------------------------------------------------ the step


def _diff_in_lr(got: dict, ref: dict, lr: float):
    """(max |diff| / lr, entries with |diff| > 1e-3 lr, entries)."""
    worst, over, total = 0.0, 0, 0
    for n, r in ref.items():
        d = np.abs(np.asarray(got[n], np.float64) - r) / lr
        worst = max(worst, float(d.max()))
        over += int((d > 1e-3).sum())
        total += d.size
    return worst, over, total


def test_train_steps_equal_reference_jitted_steps():
    """Three ``recsys_train_step`` calls against the reference's jitted
    step from the same parameters and batches: losses within 1e-5
    relative; after the first step gradients within GRAD_TOL (via the
    optimizer's m = 0.1 g); parameters within 1e-3 lr everywhere but at
    most 1 in 1,000 entries, and within 2 lr a step there."""
    rcfg, params, tcfg, model = _model()
    lr = 1e-3
    r_opt, t_opt = radamw.AdamW(lr=lr), tadamw.AdamW(lr=lr)
    r_step = jax.jit(rsteps.recsys_train_step(rcfg, r_opt))
    t_step = tsteps.recsys_train_step(tcfg, t_opt)
    r_state, t_state = r_opt.init(params), t_opt.init(model)
    for k in range(3):
        batch = _batch(rcfg, B=24, step=k)
        params, r_state, r_m = r_step(params, r_state,
                                      {n: jnp.asarray(v)
                                       for n, v in batch.items()})
        model, t_state, t_m = t_step(model, t_state, batch)
        assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= \
            1e-5 * abs(float(r_m["loss"]))
        if k == 0:
            _close_per_leaf({n: t.numpy() for n, t in t_state.m.items()},
                            _names(r_state.m), GRAD_TOL)
        worst, over, total = _diff_in_lr(
            {n: p.detach().numpy() for n, p in tadamw.named_leaves(model)},
            _names(params), lr)
        assert over <= total // 1000, (k, over, total)
        assert worst <= 2.0 * (k + 1) + 1e-3, (k, worst)
    assert int(t_state.step) == int(r_state.step) == 3


def test_train_step_turns_gradients_on_for_its_model():
    _, _, tcfg, model = _model()
    assert not any(p.requires_grad for p in model.parameters())
    opt = tadamw.AdamW(lr=1e-3)
    step = tsteps.recsys_train_step(tcfg, opt)
    before = model.recsys.cin_w[0].detach().clone()
    model2, st, m = step(model, opt.init(model),
                         _batch(rxdeepfm.smoke(), B=8))
    assert model2 is model and int(st.step) == 1
    assert all(p.requires_grad for p in model.parameters())
    assert not torch.equal(before, model.recsys.cin_w[0].detach())
    assert m["loss"].grad_fn is None


def test_train_step_frees_its_gradients():
    """No reference cycle keeps a step's gradients (at full width 1.6 GB
    a tree) alive until the garbage collector runs: with the collector
    off, steps leave no tensor behind."""
    import gc
    rcfg, _, tcfg, model = _model()
    opt = tadamw.AdamW(lr=1e-3)
    step = tsteps.recsys_train_step(tcfg, opt)
    state = opt.init(model)
    gc.collect()
    gc.disable()
    try:
        counts = []
        for k in range(3):
            model, state, m = step(model, state, _batch(rcfg, B=8, step=k))
            del m
            counts.append(sum(1 for o in gc.get_objects()
                              if torch.is_tensor(o)))
        assert gc.collect() == 0 and counts[0] == counts[-1], counts
    finally:
        gc.enable()


# ----------------------------------------------------------- checkpoints


def _trained_pair(steps=1):
    rcfg, params, tcfg, model = _model()
    r_opt = radamw.AdamW(lr=1e-3)
    r_step = jax.jit(rsteps.recsys_train_step(rcfg, r_opt))
    state = r_opt.init(params)
    for k in range(steps):
        params, state, _ = r_step(params, state, {
            n: jnp.asarray(v) for n, v in _batch(rcfg, B=16, step=k).items()})
    return rcfg, params, state, tcfg, model


def test_reference_checkpoint_restores_in_port_with_equal_bits(tmp_path):
    rcfg, params, state, tcfg, model = _trained_pair()
    rckpt.save(str(tmp_path), 1, params, state, extra={"cursor": 1})
    assert tckpt.latest_step(str(tmp_path)) == 1
    fresh = T.init_params(tcfg, torch.Generator().manual_seed(9))
    opt_like = tadamw.AdamW().init(fresh)
    p2, o2, mf = tckpt.restore(str(tmp_path), 1, fresh, opt_like)
    assert p2 is fresh and mf["extra"] == {"cursor": 1}
    for n, a in _names(params).items():
        assert np.array_equal(dict(tadamw.named_leaves(p2))[n].detach()
                              .numpy(), a), n
    assert int(o2.step) == int(state.step) == 1
    for field in ("m", "v"):
        for n, a in _names(getattr(state, field)).items():
            assert np.array_equal(getattr(o2, field)[n].numpy(), a), n


def test_port_checkpoint_restores_in_reference_with_equal_bits(tmp_path):
    rcfg, params, state, tcfg, model = _trained_pair()
    t_state = convert.adamw_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state), model)
    tckpt.save(str(tmp_path), 5, model, t_state, extra={"cursor": 5})
    p2, o2, mf = rckpt.restore(str(tmp_path), 5, params, state)
    assert mf["extra"] == {"cursor": 5}
    for n, a in _names(p2).items():
        assert np.array_equal(a, dict(tadamw.named_leaves(model))[n]
                              .detach().numpy()), n
    for field in ("m", "v"):
        for n, a in _names(getattr(o2, field)).items():
            assert np.array_equal(a, getattr(t_state, field)[n].numpy()), n
    assert int(o2.step) == 1


def test_checkpoint_keys_equal_reference(tmp_path):
    rcfg, params, state, tcfg, model = _trained_pair(steps=0)
    rckpt.save(str(tmp_path / "r"), 0, params, state)
    tckpt.save(str(tmp_path / "t"), 0, model, tadamw.AdamW().init(model))
    mr = (tmp_path / "r" / "step_0" / "manifest.json").read_text()
    mt = (tmp_path / "t" / "step_0" / "manifest.json").read_text()
    assert mr == mt
    with np.load(tmp_path / "r" / "step_0" / "shard_0.npz") as zr, \
            np.load(tmp_path / "t" / "step_0" / "shard_0.npz") as zt:
        assert list(zr.keys()) == list(zt.keys())
        assert zr["o/.step"].dtype == zt["o/.step"].dtype == np.int32
        for k in zr.keys():
            assert zr[k].dtype == zt[k].dtype and \
                zr[k].shape == zt[k].shape, k
    assert not list(tmp_path.glob("*/step_0.tmp"))


def test_bf16_leaves_round_trip_both_ways(tmp_path):
    """npz has no bf16: stored as float32, re-cast on restore; the same
    bits in both packages."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3)).astype(np.float32)
    c = rng.normal(size=(4,)).astype(np.float32)
    t_params = {"a": torch.tensor(a), "b": {"c": torch.tensor(c).to(
        torch.bfloat16)}}
    r_params = {"a": jnp.asarray(a), "b": {"c": jnp.asarray(c, jnp.bfloat16)}}
    opt = tadamw.AdamW()
    tckpt.save(str(tmp_path / "t"), 7, t_params, opt.init(t_params),
               extra={"cursor": 7})
    rckpt.save(str(tmp_path / "r"), 7, r_params,
               radamw.AdamW().init(r_params))
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(
        4, dtype=torch.bfloat16)}}
    for d in ("t", "r"):
        p2, o2, mf = tckpt.restore(str(tmp_path / d), 7, like,
                                   opt.init(like))
        assert p2["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(p2["b"]["c"], t_params["b"]["c"])
        assert torch.equal(p2["a"], t_params["a"]) and int(o2.step) == 0
    rp, _, mf = rckpt.restore(str(tmp_path / "t"), 7, r_params,
                              radamw.AdamW().init(r_params))
    assert mf["extra"]["cursor"] == 7 and rp["b"]["c"].dtype == jnp.bfloat16
    assert np.array_equal(
        np.asarray(rp["b"]["c"], np.float32),
        t_params["b"]["c"].to(torch.float32).numpy())


def test_adamw_state_from_jax_equal_bits_then_the_same_next_step():
    rcfg, params, state, tcfg, _ = _trained_pair()
    model = convert.recsys_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    t_state = convert.adamw_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state), model)
    assert int(t_state.step) == 1
    for field in ("m", "v"):
        got = getattr(t_state, field)
        assert list(got) == [n for n, _ in tadamw.named_leaves(model)]
        for n, a in _names(getattr(state, field)).items():
            assert got[n].dtype == torch.float32
            assert np.array_equal(got[n].numpy(), a), n
    with pytest.raises(ValueError, match="names differ"):
        convert.adamw_state_from_jax(
            radamw.AdamWState(step=1, m={"x": np.zeros(1)},
                              v={"x": np.zeros(1)}), model)


# ------------------------------------------------------------- trainer


def _linear_problem():
    w_true = np.array([1.0, -2.0, 0.5], np.float32)

    def batch_at(step):
        rng = np.random.default_rng(step)
        x = rng.normal(size=(32, 3)).astype(np.float32)
        return {"x": x, "y": x @ w_true}
    return batch_at


def _t_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def test_trainer_restart_resumes(tmp_path):
    """The reference's case: fit, then fit again from the checkpoint dir
    (a crash-restart); and a run stopped at step 15 and resumed equals
    the uninterrupted run bit for bit."""
    batch_at = _linear_problem()
    opt = tadamw.AdamW(lr=5e-2, weight_decay=0.0)
    quiet = dict(log=lambda *_: None)
    cfg = ttrainer.TrainerConfig(steps=30, ckpt_dir=str(tmp_path / "a"),
                                 ckpt_every=10, log_every=100)
    p1, _, _ = ttrainer.fit(_t_loss, {"w": torch.zeros(3)}, batch_at, opt,
                            cfg, **quiet)
    p2, _, _ = ttrainer.fit(_t_loss, {"w": torch.zeros(3)}, batch_at, opt,
                            cfg, **quiet)
    assert torch.allclose(p1["w"], p2["w"], atol=1e-6)
    half = dataclasses.replace(cfg, steps=16, ckpt_dir=str(tmp_path / "b"))
    ttrainer.fit(_t_loss, {"w": torch.zeros(3)}, batch_at, opt, half,
                 **quiet)
    assert tckpt.latest_step(str(tmp_path / "b")) == 15
    logs = []
    p3, st3, hist = ttrainer.fit(
        _t_loss, {"w": torch.zeros(3)}, batch_at, opt,
        dataclasses.replace(half, steps=30), log=logs.append)
    assert logs[0] == "[trainer] restored step 15, resuming at 16"
    assert torch.equal(p3["w"], p1["w"]) and int(st3.step) == 30
    assert hist[-1][0] == 29


def test_fit_tracks_reference_fit():
    """The same loss, data and optimizer in both packages' loops: the
    loss histories and final weights agree to float32 order."""
    batch_at = _linear_problem()

    def r_loss(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
    cfg_r = rtrainer.TrainerConfig(steps=20, log_every=5)
    cfg_t = ttrainer.TrainerConfig(steps=20, log_every=5)
    pr, _, hr = rtrainer.fit(r_loss, {"w": jnp.zeros(3)}, batch_at,
                             radamw.AdamW(lr=5e-2), cfg_r,
                             log=lambda *_: None)
    pt, _, ht = ttrainer.fit(_t_loss, {"w": torch.zeros(3)}, batch_at,
                             tadamw.AdamW(lr=5e-2), cfg_t,
                             log=lambda *_: None)
    assert [s for s, _ in hr] == [s for s, _ in ht] == [0, 5, 10, 15, 19]
    np.testing.assert_allclose([l for _, l in ht], [l for _, l in hr],
                               rtol=1e-5)
    np.testing.assert_allclose(pt["w"].detach().numpy(), np.asarray(pr["w"]),
                               rtol=1e-5, atol=1e-6)


def test_grad_accum_equivalence():
    """4 micro-batches accumulated equal one batch of all of them."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16, 3)).astype(np.float32)
    y = rng.normal(size=(4, 16)).astype(np.float32)
    opt = tadamw.AdamW(lr=1e-2, weight_decay=0.0, grad_clip=None)
    params = {"w": torch.ones(3)}
    step = ttrainer.make_accum_step(_t_loss, opt, 4)
    p_a, _, loss_a = step(params, opt.init(params),
                          {"x": torch.tensor(x), "y": torch.tensor(y)})
    big = {"w": torch.ones(3)}
    loss_b, grads = ttrainer.value_and_grad(
        _t_loss, big, {"x": torch.tensor(x.reshape(64, 3)),
                       "y": torch.tensor(y.reshape(64))})
    p_b, _ = opt.update(grads, opt.init(big), big)
    np.testing.assert_allclose(p_a["w"].detach().numpy(),
                               p_b["w"].detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-5)


def test_fit_with_grad_accum_takes_stacked_batches():
    rng = np.random.default_rng(1)

    def batch_at(step):
        x = rng.normal(size=(2, 8, 3)).astype(np.float32)
        return {"x": x, "y": x.sum(-1)}
    cfg = ttrainer.TrainerConfig(steps=3, log_every=1, grad_accum=2)
    _, st, hist = ttrainer.fit(_t_loss, {"w": torch.zeros(3)}, batch_at,
                               tadamw.AdamW(lr=1e-2), cfg,
                               log=lambda *_: None)
    assert int(st.step) == 3 and [s for s, _ in hist] == [0, 1, 2]


# ------------------------------------------------- elastic, compression


@pytest.mark.parametrize("n,model_axis,batch,prev", [
    (192, 16, 256, 16), (8, 16, 256, 16), (256, 16, 256, 16),
    (7, 4, 64, 2), (1, 8, 32, 4), (100, 3, 96, 40)])
def test_elastic_remesh_plans_equal_reference(n, model_axis, batch, prev):
    r = relastic.remesh(n_devices=n, model_axis=model_axis,
                        global_batch=batch, prev_data_axis=prev)
    t = telastic.remesh(n_devices=n, model_axis=model_axis,
                        global_batch=batch, prev_data_axis=prev)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)


def test_elastic_mesh_from_plan_and_timeouts():
    plan = telastic.remesh(n_devices=6, model_axis=2, global_batch=12,
                           prev_data_axis=4)
    assert plan.mesh_shape == (3, 2) and plan.grad_accum == 2
    mesh = telastic.make_mesh_from_plan(plan, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 3, "model": 2}
    assert telastic.DEFAULT_TIMEOUTS == relastic.DEFAULT_TIMEOUTS


def test_gradient_compression_error_feedback():
    """The reference's case, and the same bf16 payloads and residuals
    bit for bit."""
    params = {"w": torch.zeros(64)}
    res = tcompress.init_residual(params)
    r_res = rcompress.init_residual({"w": jnp.zeros((64,))})
    rng = np.random.default_rng(0)
    total_true, total_sent = np.zeros(64), np.zeros(64)
    for _ in range(50):
        g = rng.normal(size=64).astype(np.float32) * 1e-3
        q, res = tcompress.compress_with_feedback({"w": torch.tensor(g)},
                                                  res)
        rq, r_res = rcompress.compress_with_feedback({"w": jnp.asarray(g)},
                                                     r_res)
        assert q["w"].dtype == torch.bfloat16
        assert np.array_equal(q["w"].to(torch.float32).numpy(),
                              np.asarray(rq["w"], np.float32))
        assert np.array_equal(res["w"].numpy(), np.asarray(r_res["w"]))
        total_true += g
        total_sent += tcompress.decompress(q)["w"].numpy()
    assert np.abs(total_true - total_sent).max() < 1e-4


# ------------------------------------------------------------------ CLI


def test_train_cli_logs_three_losses_and_checkpoints(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "xdeepfm", "--device", "cpu", "--steps", "3", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if " loss " in ln]
    assert [ln.split()[2] for ln in lines] == ["0", "1", "2"]
    assert all(np.isfinite(float(ln.split()[4])) for ln in lines)
    assert tckpt.latest_step(str(tmp_path)) == 2
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "sling-serve", "--device", "cpu"], capture_output=True, text=True,
        env=env, timeout=120, cwd=tmp_path)
    assert bad.returncode != 0 and "has no train entrypoint" in bad.stderr


def test_port_training_modules_import_no_jax():
    code = ("import sys; import repro_torch.launch.train, "
            "repro_torch.train.trainer, repro_torch.train.checkpoint, "
            "repro_torch.train.elastic, repro_torch.optim.compress; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))] + "
            "(['repro'] if 'repro' in sys.modules else []); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
