"""Mixture-of-Experts layer with a capacity-limited router (port of
``repro/models/moe.py``).

Under an active mesh (``launch.sharding.use_mesh_rules``) whose "pod"
and "data" axes hold more than one position, the tokens split into G
contiguous groups, one a data shard in row-major (pod, data) order, and
each group runs ``_moe_local`` on its own shard's device with its own
capacity ``C_l = ceil(T_l * k / E * cf)``: the reference's
``shard_map`` branch, single-controller. The expert weights are read
whole (the reference leaves the "model" axis to GSPMD, which does not
change values), cast to the tokens' dtype once a device (``_Shared``);
the outputs come back in order on the caller's device and the aux loss
is the mean of the G groups'. Without a mesh, without such an axis, or
where G does not divide T, ``_moe_local`` runs on all the tokens at
once: the reference's semantics for one group.

``_moe_local`` is three steps that the partitioned LM step
(``models/transformer_sharded.py``) also runs, on a group's tokens and
a position's experts: ``dispatch`` (router, top-k, ranks, capacity,
slots: a :class:`Route`), ``scatter`` into the buffer and
``expert_ffn``, and ``combine``; ``scatter`` and ``combine`` take an
expert range [lo, hi), every expert by default.

Dispatch is bit-compatible with the reference on the same router
output: the top k by a stable descending sort (``jax.lax.top_k`` gives
a tie to the lower expert), a stable argsort by expert, ranks within an
expert, capacity ``C = ceil(T * k / E * cf)``; an assignment past C
lands at rank C - 1 with a zero row. Both scatters are ``index_add``
over flattened rows (on the card an atomic add, where advanced-index
accumulation sorts and adds runs of equal indices serially). The expert
FFN runs in the tokens' dtype, the router in float32; the aux
load-balance loss takes its gradient through ``probs`` only.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.launch.sharding import active_mesh
from repro_torch.models.layers import silu


def _top_k(probs: torch.Tensor, k: int):
    """(values, ids) of the k largest of each row, descending, a tie to
    the lower id (as ``jax.lax.top_k``)."""
    _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids = order[..., :k]
    return probs.gather(-1, ids), ids


class Route(NamedTuple):
    """The dispatch of a block of T tokens: the router's ``probs`` (T, E)
    and top-k ``expert_idx`` (T, k), and the T * k assignments sorted by
    expert (stably): expert ``se``, gate weight ``sw``, token ``st``,
    whether it is within the capacity ``ok`` and its row ``slot`` of the
    (E * C, d) buffer (an assignment past C at rank C - 1)."""
    probs: torch.Tensor
    expert_idx: torch.Tensor
    se: torch.Tensor
    sw: torch.Tensor
    st: torch.Tensor
    ok: torch.Tensor
    slot: torch.Tensor
    C: int

    @property
    def E(self) -> int:
        return self.probs.shape[-1]

    def aux(self):
        """The load-balance loss, its gradient through ``probs`` only."""
        one_hot = torch.nn.functional.one_hot(self.expert_idx, self.E).to(
            torch.float32)
        frac_tokens = one_hot.sum(1).mean(0)
        return self.E * torch.sum(frac_tokens * self.probs.mean(0))


def dispatch(x, router_w, top_k: int, capacity_factor: float) -> Route:
    """The router (float32), top-k, ranks within an expert, capacity
    ``C = ceil(T * k / E * cf)`` and buffer slots of tokens x (T, d)."""
    T = x.shape[0]
    E = router_w.shape[-1]
    C = max(1, int(math.ceil(T * top_k / E * capacity_factor)))

    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                  # (T, E)
    gate_vals, expert_idx = _top_k(probs, top_k)           # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    flat_e = expert_idx.reshape(-1)                        # (T*k,)
    flat_w = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    sw = flat_w[order]
    st = order // top_k

    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(T * top_k, device=x.device) - first
    ok = rank < C
    slot = se * C + torch.clamp(rank, 0, C - 1)            # row of (E*C, d)
    return Route(probs, expert_idx, se, sw, st, ok, slot, C)


def _mine(route: Route, lo: int, hi: int):
    """(the assignments kept and within experts [lo, hi), their rows of
    that range's (hi - lo) * C buffer)."""
    if (lo, hi) == (0, route.E):
        return route.ok, route.slot
    mine = route.ok & (route.se >= lo) & (route.se < hi)
    return mine, torch.clamp(route.slot - lo * route.C, 0,
                             (hi - lo) * route.C - 1)


def scatter(x, route: Route, lo: int = 0, hi: int | None = None):
    """The (hi - lo, C, d) buffer of experts [lo, hi) (every expert by
    default): each kept assignment's token at its slot, zero elsewhere."""
    hi = route.E if hi is None else hi
    mine, slot = _mine(route, lo, hi)
    d = x.shape[1]
    gathered = torch.where(mine[:, None], x.index_select(0, route.st),
                           torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros(((hi - lo) * route.C, d), dtype=x.dtype,
                      device=x.device)
    return buf.index_add(0, slot, gathered).view(hi - lo, route.C, d)


def expert_ffn(buf, w_gate, w_up, w_down):
    """The experts' SwiGLU over their buffer rows (E, C, d), in the
    buffer's dtype."""
    h = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    return torch.bmm(silu(h) * u, w_down.to(h.dtype))


def combine(out_buf, route: Route, T: int, dtype, lo: int = 0,
            hi: int | None = None):
    """y (T, d) in ``dtype``: each token's kept assignments to experts
    [lo, hi) (every expert by default), ``out_buf`` (hi - lo, C, d) at
    the assignment's slot times its gate weight (in ``out_buf``'s
    dtype), added in the sorted order."""
    hi = route.E if hi is None else hi
    mine, slot = _mine(route, lo, hi)
    d = out_buf.shape[-1]
    sw = route.sw
    weight = torch.where(mine, sw, torch.zeros((), dtype=sw.dtype,
                                               device=sw.device))
    back = out_buf.reshape(-1, d).index_select(0, slot) \
        * weight[:, None].to(out_buf.dtype)
    return torch.zeros((T, d), dtype=dtype, device=out_buf.device).index_add(
        0, route.st, back.to(dtype))


def _moe_local(x, router_w, w_gate, w_up, w_down, top_k: int,
               capacity_factor: float):
    """Dispatch, expert FFN and combine on a block of tokens x (T, d);
    returns (y (T, d), aux)."""
    route = dispatch(x, router_w, top_k, capacity_factor)
    out_buf = expert_ffn(scatter(x, route), w_gate, w_up, w_down)
    return combine(out_buf, route, x.shape[0], x.dtype), route.aux()


class _Shared(torch.autograd.Function):
    """An expert weight as ``cast`` (its copy in the tokens' dtype on a
    group's device, made once for every group there), its gradient sent
    back to the weight in the weight's dtype and device, group by group:
    the bits of each group's own ``w.to(dtype)``, whose forward and
    backward these are. The groups that share a card share one cast,
    which the backward holds once instead of once a group."""

    @staticmethod
    def forward(ctx, w, cast):
        ctx.dtype, ctx.device = w.dtype, w.device
        return cast.view_as(cast)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.device, ctx.dtype), None


def moe_ffn(x, router_w, w_gate, w_up, w_down, top_k: int,
            capacity_factor: float = 1.25):
    """x: (T, d) tokens; returns (T, d) and the aux load-balance loss
    (see the module docstring for the mesh branch)."""
    mesh = active_mesh()
    manual = tuple(a for a in ("pod", "data") if mesh is not None
                   and a in mesh.shape and mesh.shape[a] > 1)
    T = x.shape[0]
    G = math.prod(mesh.shape[a] for a in manual) if manual else 1
    if not manual or T % G != 0:
        return _moe_local(x, router_w, w_gate, w_up, w_down, top_k,
                          capacity_factor)
    devs = mesh.axes_devices(manual)
    casts = {}
    with torch.no_grad():                  # one cast a device, see _Shared
        for dev in devs:
            if dev not in casts:
                casts[dev] = [w.detach().to(dev, x.dtype)
                              for w in (w_gate, w_up, w_down)]
    ys, auxes = [], []
    for xl, dev in zip(x.split(T // G), devs):
        wg, wu, wd = (_Shared.apply(w, c) for w, c in
                      zip((w_gate, w_up, w_down), casts[dev]))
        y, aux = _moe_local(xl.to(dev), router_w.to(dev), wg, wu, wd,
                            top_k, capacity_factor)
        ys.append(y.to(x.device))
        auxes.append(aux.to(x.device))
    return torch.cat(ys), torch.stack(auxes).mean()
