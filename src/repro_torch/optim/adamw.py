"""AdamW from scratch (port of ``repro/optim/adamw.py``).

The state is float32 whatever the parameter's dtype, and the update
keeps the reference's math and its order of operations: global-norm
clipping, then bias-corrected m and v, then ``delta = mhat / (sqrt(vhat)
+ eps) + wd * p``, then ``p - lr * delta``, with weight decay on every
leaf. ``torch.optim.AdamW`` is not used: it decays before the step, in
another rounding order, and its state has neither the reference's
layout nor its names, which the checkpoint needs.

Parameters are an ``nn.Module`` (its ``named_parameters``) or a nested
dict / list of tensors. Leaves are named as the reference's checkpoint
names them ("recsys/cin_w/0", "tables/embed") and ordered as
``jax.tree`` flattens: dict keys sorted, list items in order. Gradients
and the state's ``m`` and ``v`` are dicts over those names. The update
writes the new values into the parameters and the state's tensors in
place (the port's tensors are mutable; at full xDeepFM width a copy
would cost another 1.73 GB a tree) and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor             # () int32
    m: dict[str, torch.Tensor]     # name -> float32, like the parameters
    v: dict[str, torch.Tensor]


def _sort_key(name: str) -> tuple:
    return tuple((0, int(c)) if c.isdigit() else (1, c)
                 for c in name.split("/"))


def _walk(node, prefix: str):
    """(name, leaf) pairs of a nested dict / list, depth first. A module
    function, not a closure: a recursive closure is a reference cycle
    that would hold the leaves (a tree of gradients) until the garbage
    collector runs."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, f"{prefix}{k}/")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], node


def named_leaves(params: Any) -> list[tuple[str, torch.Tensor]]:
    """[(name, tensor)] of a module or a nested dict / list of tensors,
    in ``jax.tree`` order, under the reference checkpoint's names."""
    if isinstance(params, nn.Module):
        flat = [(n.replace(".", "/"), p) for n, p in params.named_parameters()]
    else:
        flat = list(_walk(params, ""))
    return sorted(flat, key=lambda kv: _sort_key(kv[0]))


def state_leaves(state: AdamWState) -> list[tuple[str, Any]]:
    """[(name, leaf)] of an ``AdamWState`` under the reference
    checkpoint's names: ".step", then ".m/<name>" and ".v/<name>" in
    ``named_leaves`` order (the fields of ``jax.tree``'s NamedTuple
    path, whose keys print with a leading dot)."""
    return ([(".step", state.step)]
            + [(f".m/{n}", t) for n, t in named_leaves(state.m)]
            + [(f".v/{n}", t) for n, t in named_leaves(state.v)])


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float | None = 1.0

    def init(self, params) -> AdamWState:
        leaves = named_leaves(params)
        dev = leaves[0][1].device if leaves else None
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in leaves},
            v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in leaves})

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: AdamWState,
               params):
        """(params, state) after one step on ``grads`` ({name: tensor},
        the names of :func:`named_leaves`); params and the state's m and
        v are updated in place."""
        step = state.step + 1
        leaves = named_leaves(params)
        if set(grads) != {n for n, _ in leaves}:
            raise ValueError(f"gradients for {sorted(grads)}, parameters "
                             f"{[n for n, _ in leaves]}")
        gs = [grads[n] for n, _ in leaves]
        if self.grad_clip is not None:
            gn = global_norm(gs)
            scale = torch.clamp(self.grad_clip / (gn + 1e-12), max=1.0)
            gs = [g * scale for g in gs]
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        s32 = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=s32.device), s32)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=s32.device), s32)
        for (name, p), g in zip(leaves, gs):
            m, v = state.m[name], state.v[name]
            g32 = g.to(torch.float32)
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(g32.mul(1 - b2).mul_(g32))
            mhat = m / c1
            vhat = v / c2
            delta = mhat.div_(vhat.sqrt_().add_(self.eps))
            p32 = p.to(torch.float32)
            delta.add_(self.weight_decay * p32)
            p.copy_(p32 - lr * delta)
        return params, AdamWState(step=step, m=state.m, v=state.v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(l^2), in float32, for anything
    :func:`named_leaves` takes (a list of tensors, a {name: tensor} dict,
    a module)."""
    total = sum(torch.sum(torch.square(l.to(torch.float32)))
                for _, l in named_leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """lr(step): linear warmup to ``peak``, then a cosine down to
    ``floor * peak`` at ``total``, in float32 as the reference computes
    it; ``step`` is an integer tensor."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)
    return lr
