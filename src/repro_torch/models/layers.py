"""Shared building blocks (port of ``repro/models/layers.py``:
``dense_init``; ``rms_norm``, ``rope``, ``silu``, ``swiglu`` and
``softmax_cross_entropy`` for the LM stack; ``leaky_relu`` and
``segment_softmax`` for the GNN stack).

The LM layers round where the reference rounds: ``rms_norm`` and
``rope`` compute in float32 and return the input's dtype; RMSNorm
scales by ``1 + scale`` (its scale starts at zero), and ``rope``
rotates the two halves of the head dimension, not interleaved pairs.

The segment ops are the port's own counterparts of the reference's
``compat.segment_sum`` and ``jax.ops.segment_max``. Ids out of range
are dropped, as the reference's scatters drop them (``index_add_`` and
``scatter_reduce`` would raise), and an empty segment sums to 0 and has
the maximum -inf. ``compat.segment_sum`` indexes as NumPy does before
it drops (``.at[ids].add(mode="drop")``): an id in [-num_segments, 0)
counts from the end, whatever its docstring says; ``segment_max`` drops
every negative id. The port does what each does. Under autograd
``scatter_reduce``'s "amax" splits a gradient evenly among the entries
tied at a segment's maximum, as JAX's scatter-max JVP does.
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal weights on ``gen``'s device, scaled by ``scale`` or by
    1/sqrt(fan_in) (the second-to-last dim, or the last of a vector)."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(s).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)`` over the last dim, in float32,
    returned in ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh), positions: (..., S). The
    first half of Dh rotates against the second."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(x, w_gate, w_up, w_down):
    g = silu(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of integer ``labels`` under
    ``logits`` (..., V), in float32; with ``mask``, the masked mean."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``x`` where x >= 0, else ``slope * x``: the reference's form,
    whose gradient at 0 is 1 (``F.leaky_relu``'s is the slope)."""
    return torch.where(x >= 0, x, slope * x)


def _kept(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
          fill: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(data with the rows of out-of-range ids set to ``fill``, the ids
    clamped into range as int64): a dropped row lands on a segment
    where ``fill`` is the reduction's identity."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    keep = keep.view((-1,) + (1,) * (data.dim() - 1))
    return (torch.where(keep, data, fill),
            ids.clamp(0, max(num_segments - 1, 0)))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments, *data.shape[1:]): the sum of the rows of ``data``
    whose id is each segment (``compat.segment_sum``; an id in
    [-num_segments, 0) counts from the end)."""
    ids = segment_ids.long()
    ids = torch.where(ids < 0, ids + num_segments, ids)
    data, ids = _kept(data, ids, num_segments, 0.0)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, ids, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments, *data.shape[1:]): the maximum of the rows of
    ``data`` whose id is each segment, -inf for an empty segment
    (``jax.ops.segment_max``)."""
    data, ids = _kept(data, segment_ids, num_segments, -math.inf)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -math.inf,
                     dtype=data.dtype, device=data.device)
    index = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax", include_self=False)


def segment_softmax(scores: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax over groups (GAT edge scores grouped by destination),
    each column of a (M, H) ``scores`` on its own."""
    # the reference gathers as JAX indexes: a negative id counts from
    # the end once, then every id is clamped into range
    ids = seg_ids.long()
    ids = torch.where(ids < 0, ids + num_segments, ids).clamp(
        0, max(num_segments - 1, 0))
    smax = segment_max(scores, seg_ids, num_segments)
    ex = torch.exp(scores - smax.index_select(0, ids))
    den = segment_sum(ex, seg_ids, num_segments)
    return ex / torch.clamp(den.index_select(0, ids), min=1e-20)
