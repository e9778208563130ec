"""Training loop: gradient accumulation, checkpoint/restart, metrics
(port of ``repro/train/trainer.py``).

Runs on one device, CPU or CUDA: the device of the parameters. The loop
is restart-safe: data is step-keyed and the checkpoint carries the step
cursor. ``loss_fn(params, batch)`` returns a scalar tensor; batches
are dicts of NumPy arrays or tensors, moved to the parameters' device
here. The parameters train in place: each leaf records a gradient for
the loop (``requires_grad``) and the optimizer writes the new values
into it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.optim.adamw import AdamW, named_leaves
from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    grad_accum: int = 1


def trainable(params) -> list[tuple[str, torch.Tensor]]:
    """:func:`~repro_torch.optim.adamw.named_leaves` of ``params``, each
    leaf set to record a gradient."""
    leaves = named_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    return leaves


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, {name: gradient}) of ``loss_fn(params, batch)``; a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives it."""
    leaves = trainable(params)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(leaves, grads)}


def to_device(batch: dict, params) -> dict:
    """``batch`` with every array as a tensor on the parameters' device."""
    dev = named_leaves(params)[0][1].device
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_accum_step(loss_fn: Callable, opt: AdamW, accum: int):
    """loss_fn(params, batch) -> scalar. Returns step(params, opt_state,
    batches) where batches is a dict of arrays with a leading axis of
    ``accum`` micro-batches: the gradients are summed over them in
    order in float32, divided by ``accum`` and applied once."""

    def step(params, opt_state, batches):
        total, loss = None, torch.zeros((), dtype=torch.float32)
        for i in range(accum):
            b = to_device({k: v[i] for k, v in batches.items()}, params)
            l, g = value_and_grad(loss_fn, params, b)
            g = {n: t.to(torch.float32) for n, t in g.items()}
            total = g if total is None else {
                n: total[n] + g[n] for n in total}
            loss = loss.to(l.device) + l
        grads = {n: t / accum for n, t in total.items()}
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss / accum

    return step


def fit(loss_fn: Callable, params, batch_at: Callable[[int], Any],
        opt: Optional[AdamW] = None, cfg: TrainerConfig = TrainerConfig(),
        opt_state=None, start_step: Optional[int] = None,
        log: Callable[[str], None] = print):
    """Generic fit loop. ``batch_at(step)`` supplies data (step-keyed).

    Resumes from cfg.ckpt_dir when a checkpoint exists (restart path).
    Returns (params, opt_state, history).
    """
    opt = opt or AdamW()
    if opt_state is None:
        opt_state = opt.init(params)
    step0 = 0
    if start_step is not None:
        step0 = start_step
    elif cfg.ckpt_dir:
        last = ckpt_lib.latest_step(cfg.ckpt_dir)
        if last is not None:
            params, opt_state, mf = ckpt_lib.restore(
                cfg.ckpt_dir, last, params, opt_state)
            step0 = mf["step"] + 1
            log(f"[trainer] restored step {last}, resuming at {step0}")

    if cfg.grad_accum > 1:
        step_fn = make_accum_step(loss_fn, opt, cfg.grad_accum)
    else:
        def step_fn(params, opt_state, batch):
            loss, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, loss

    history = []
    t0 = time.perf_counter()
    for step in range(step0, cfg.steps):
        batch = to_device(batch_at(step), params)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if step % cfg.log_every == 0 or step == cfg.steps - 1:
            l = float(loss)
            dt = time.perf_counter() - t0
            log(f"[trainer] step {step} loss {l:.4f} ({dt:.1f}s)")
            history.append((step, l))
        if cfg.ckpt_dir and (step % cfg.ckpt_every == 0
                             or step == cfg.steps - 1):
            ckpt_lib.save(cfg.ckpt_dir, step, params, opt_state)
    return params, opt_state, history
