"""Mixture-of-Experts layer with a capacity-limited router (port of
``repro/models/moe.py``, its local path).

The reference runs ``_moe_local`` under ``shard_map`` over the mesh's
data axes when a mesh is active, so that each data shard dispatches its
own tokens with a per-device capacity; without a mesh it calls
``_moe_local`` directly. The port has no such mesh yet (ROADMAP.md,
queue 1, item 3): its ``moe_ffn`` always takes the local path, which is
the reference's semantics for one group of tokens.

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

import torch

from repro_torch.models.layers import silu


def _top_k(probs: torch.Tensor, k: int):
    """(values, ids) of the k largest of each row, descending, a tie to
    the lower id (as ``jax.lax.top_k``)."""
    _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids = order[..., :k]
    return probs.gather(-1, ids), ids


def _moe_local(x, router_w, w_gate, w_up, w_down, top_k: int,
               capacity_factor: float):
    """Dispatch, expert FFN and combine on a block of tokens x (T, d);
    returns (y (T, d), aux)."""
    T, d = x.shape
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

    gathered = torch.where(ok[:, None], x.index_select(0, st),
                           torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, gathered).view(E, C, d)

    h = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    out_buf = torch.bmm(silu(h) * u, w_down.to(h.dtype)).view(E * C, d)

    weight = torch.where(ok, sw, torch.zeros((), dtype=sw.dtype,
                                             device=sw.device))
    back = out_buf.index_select(0, slot) * weight[:, None].to(x.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add(
        0, st, back)

    one_hot = torch.nn.functional.one_hot(expert_idx, E).to(torch.float32)
    frac_tokens = one_hot.sum(1).mean(0)
    aux = E * torch.sum(frac_tokens * probs.mean(0))
    return y, aux


def moe_ffn(x, router_w, w_gate, w_up, w_down, top_k: int,
            capacity_factor: float = 1.25):
    """x: (T, d) tokens; returns (T, d) and the aux load-balance loss.

    Always the local path: the reference's ``shard_map`` branch needs an
    active mesh, which the port does not have yet."""
    return _moe_local(x, router_w, w_gate, w_up, w_down, top_k,
                      capacity_factor)
