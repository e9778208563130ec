"""Flash attention in plain PyTorch with a hand-written backward (port of
``repro/models/flash_attention.py``).

Differentiating through the chunked online softmax would keep every
chunk's score and probability tensors for the backward -- O(S^2)
memory, the thing chunking is meant to avoid. So this is the
FlashAttention-2 factorisation as a ``torch.autograd.Function``: the
forward saves only (q, k, v, isg, out, m, l), and the backward
recomputes the scores chunk by chunk.

Masking is causal, with a sliding window and a per-layer global flag
(``isg``, 0.0 or 1.0). A masked score gets ``(1 - mask) * NEG`` added,
as the reference does, not ``-inf``: under a window a row's leading
chunks can be fully masked, and then add garbage to ``l`` and ``acc``
that the later rescale ``corr = exp(m - m_new)`` wipes out, where
``-inf`` would make it NaN. Masked chunks are computed, not skipped.
Keys sit at ``arange(Sk)`` and queries at ``q_offset + arange(Sq)``:
a sequence-parallel position holds a slice of the queries against its
group's whole keys (``models/transformer_sharded.py``); the chunks cut
the keys only. Serving decode takes the dense path.

q, k and v are cast to float32 before the products, as the reference
casts them; the result is in q's dtype. These are plain torch ops on
the card too: the reference's flash attention is pure JAX (XLA), not a
Pallas kernel.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, isg: float,
          window: int) -> torch.Tensor:
    """(Sq, C) float32 0/1: key k_pos visible from query q_pos."""
    causal = (k_pos[None, :] <= q_pos[:, None]).to(torch.float32)
    if window <= 0:
        return causal
    local = (k_pos[None, :] > (q_pos[:, None] - window)).to(torch.float32)
    return causal * torch.clamp(local, min=float(isg))


def _bias(q_pos, k_pos, isg: float, window: int) -> torch.Tensor:
    return (1.0 - _mask(q_pos, k_pos, isg, window)) * NEG


def _heads_f32(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) -> (B, H, S, dh) float32, contiguous: one copy, so
    that the products take it as a plain batch of matrices."""
    return t.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format)


def _positions(q, k, q_off: int):
    q_pos = torch.arange(q_off, q_off + q.shape[1], dtype=torch.int32,
                         device=q.device)
    if q_off == 0 and k.shape[1] == q.shape[1]:
        return q_pos, q_pos
    return q_pos, torch.arange(k.shape[1], dtype=torch.int32,
                               device=q.device)


def _fwd_impl(q, k, v, isg: float, window: int, chunk: int, q_off: int = 0):
    B, Sq, H, dh = q.shape
    nc = k.shape[1] // chunk
    scale = 1.0 / math.sqrt(dh)
    qT = _heads_f32(q)                                       # (B, H, S, dh)
    q_pos, k_pos = _positions(q, k, q_off)
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        kc, vc = _heads_f32(k[:, sl]), _heads_f32(v[:, sl])  # (B, H, C, dh)
        kp = k_pos[sl]
        s = torch.matmul(qT, kc.transpose(-1, -2)).mul_(scale)
        s.add_(_bias(q_pos, kp, isg, window))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = s.sub_(m_new[..., None]).exp_()
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, vc)
        m = m_new
        del s, p
    linv = 1.0 / torch.clamp(l, min=1e-30)
    out = (acc * linv[..., None]).transpose(1, 2).to(q.dtype)
    return out, m, l


def _bwd_impl(q, k, v, isg: float, window: int, chunk: int, out, m, l,
              dout, q_off: int = 0):
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    nc = Sk // chunk
    scale = 1.0 / math.sqrt(dh)
    qT = _heads_f32(q)                                       # (B, H, S, dh)
    doT = _heads_f32(dout)
    oT = out.transpose(1, 2).to(torch.float32)
    # the softmax denominator and the row dot D_i = sum_k dOut_ik Out_ik
    linv = 1.0 / torch.clamp(l, min=1e-30)
    D = (doT * oT).sum(-1)                                   # (B, H, S)
    del oT
    q_pos, k_pos = _positions(q, k, q_off)
    dq = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, Sk, H, dh), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, H, dh), dtype=v.dtype, device=v.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        kc, vc = _heads_f32(k[:, sl]), _heads_f32(v[:, sl])  # (B, H, C, dh)
        s = torch.matmul(qT, kc.transpose(-1, -2)).mul_(scale)
        s.add_(_bias(q_pos, k_pos[sl], isg, window))
        p = s.sub_(m[..., None]).exp_().mul_(linv[..., None])  # true softmax
        dv_c = torch.matmul(p.transpose(-1, -2), doT)
        ds = torch.matmul(doT, vc.transpose(-1, -2))
        ds.sub_(D[..., None]).mul_(p).mul_(scale)
        del p, s
        dq = dq + torch.matmul(ds, kc)
        dk_c = torch.matmul(ds.transpose(-1, -2), qT)
        del ds
        dk[:, sl] = dk_c.transpose(1, 2).to(k.dtype)
        dv[:, sl] = dv_c.transpose(1, 2).to(v.dtype)
    return dq.transpose(1, 2).to(q.dtype), dk, dv


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, isg, window: int, chunk: int, q_off: int = 0):
        isg = float(isg)
        out, m, l = _fwd_impl(q, k, v, isg, window, chunk, q_off)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.isg, ctx.window, ctx.chunk, ctx.q_off = isg, window, chunk, q_off
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _bwd_impl(q, k, v, ctx.isg, ctx.window, ctx.chunk,
                               out, m, l, dout, ctx.q_off)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, isg, window: int, chunk: int,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh) at positions ``q_offset + arange(Sq)``; k / v:
    (B, Sk, H, dh) at ``arange(Sk)``, already GQA-expanded, ``Sk`` a
    multiple of ``chunk``; ``isg`` the layer's global flag (0 or 1, a
    number or a 0-d tensor). Returns (B, Sq, H, dh) in q's dtype."""
    if k.shape[1] % chunk:
        raise ValueError(f"sequence {k.shape[1]} is not a multiple of "
                         f"the attention chunk {chunk}")
    return FlashAttention.apply(q, k, v, isg, window, chunk, int(q_offset))
