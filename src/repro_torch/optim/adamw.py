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
import functools
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
        s32 = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                          device=s32.device), s32)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                          device=s32.device), s32)
        for (name, p), g in zip(leaves, gs):
            self._leaf(p, g, state.m[name], state.v[name], lr, c1, c2)
        return params, AdamWState(step=step, m=state.m, v=state.v)

    def _leaf(self, p, g, m, v, lr, c1, c2) -> None:
        """One leaf's update in place: m, v, then p."""
        b1, b2 = self.b1, self.b2
        g32 = g.to(torch.float32)
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(g32.mul(1 - b2).mul_(g32))
        mhat = m / c1
        vhat = v / c2
        delta = mhat.div_(vhat.sqrt_().add_(self.eps))
        p32 = p.to(torch.float32)
        delta.add_(self.weight_decay * p32)
        p.copy_(p32 - lr * delta)

    @torch.no_grad()
    def update_placed(self, grads: dict, state: AdamWState, params: dict):
        """(params, state) after one step over placed leaves, each mesh
        position updating its own pieces in place: ``params`` and the
        state's m and v {name: ``ShardedTensor``}, its step a replicated
        ``ShardedTensor``; ``grads`` {name: {position: the gradient of
        that position's piece}} for the positions that ran (a dry run's
        classes, ``launch/collectives.spmd``). The clip's norm sums each
        distinct piece's squares once, at the first position holding it
        (a replicated leaf counts once), all-reduced over the mesh in
        position order. A piece that shares its storage with one updated
        before (a replica on the same device) is not updated again."""
        from repro_torch.kernels.cost import is_fake
        from repro_torch.launch import collectives as C
        names = [n for n, _ in named_leaves(params)]
        if set(grads) != set(names):
            raise ValueError(f"gradients for {sorted(grads)}, parameters "
                             f"{names}")
        run = tuple(grads[names[0]])
        mesh = params[names[0]].sharding.mesh
        S = C.Spmd(mesh, run, is_fake(*grads[names[0]].values()))
        scale = {}
        if self.grad_clip is not None:
            part = {}
            for p in run:
                tot = torch.zeros((), dtype=torch.float32, device=S.dev(p))
                for n in names:
                    if _first_holder(params[n], p):
                        g = grads[n][p].to(torch.float32)
                        tot = tot + torch.sum(torch.square(g))
                part[p] = tot
            sq = C.all_reduce(S, part, mesh.axis_names, what="grad-norm")
            for p in run:
                gn = torch.sqrt(sq[p])
                scale[p] = torch.clamp(self.grad_clip / (gn + 1e-12),
                                       max=1.0)
        # every position's copy of the replicated counter moves
        steps = {p: t + 1 for p, t in state.step.pieces.items()}
        seen = set()
        for p in run:
            step = steps[p]
            lr = self.lr(step) if callable(self.lr) else self.lr
            # the corrections as ``update`` forms them, the constants
            # made beside the step (a dry run's last fake device has no
            # index, where a new constant would not be fake)
            s32 = step.to(torch.float32)
            c1 = 1.0 - torch.pow(torch.full_like(s32, self.b1), s32)
            c2 = 1.0 - torch.pow(torch.full_like(s32, self.b2), s32)
            for n in names:
                piece = params[n].pieces[p]
                if not is_fake(piece):
                    view = (piece.device, piece.data_ptr(),
                            tuple(piece.shape), piece.stride())
                    if view in seen:
                        continue
                    seen.add(view)
                g = grads[n][p]
                if p in scale:
                    g = g * scale[p]
                self._leaf(piece, g, state.m[n].pieces[p],
                           state.v[n].pieces[p], lr, c1, c2)
        new_step = dataclasses.replace(state.step, pieces=steps)
        return params, AdamWState(step=new_step, m=state.m, v=state.v)


def _first_holder(st, pos) -> bool:
    """True when ``pos`` is the first position (row-major) whose piece of
    the placed ``st`` covers its region."""
    return _holders(st.sharding, tuple(st.shape))[pos]


@functools.lru_cache(maxsize=None)
def _holders(sharding, shape: tuple) -> dict:
    first, out = {}, {}
    for p, sl in sharding.devices_indices_map(shape).items():
        key = tuple((s.start, s.stop) for s in sl)
        out[p] = first.setdefault(key, p) == p
    return out


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
