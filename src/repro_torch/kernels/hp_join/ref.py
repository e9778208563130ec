"""Plain torch oracle for the batched single-pair join (Alg 3), port of
``repro/kernels/hp_join/ref.py``.

Given the packed H rows of query pairs, gathered: keys sorted ascending
with ``PAD`` padding and values pre-multiplied by sqrt(d_k) (the sqrt-d
folding trick: h_u * d_k * h_v = (h_u sqrt(d_k)) * (h_v sqrt(d_k)),
valid since d_k >= 1-c > 0), it computes

    s~(u, v) = sum over matching keys of vu_i * vv_j.

The port's kernel gathers the rows itself (``hp_join(keys, vals, us,
vs)``); this is the oracle of the reference's row-level contract.
"""
from __future__ import annotations

import torch

PAD = 2**31 - 1


def join_ref(ku, vu, kv, vv):
    """ku/vu/kv/vv: (B, K). Returns (B,) f32."""
    K = ku.shape[1]
    idx = torch.searchsorted(kv.contiguous(), ku.contiguous())
    idx_c = idx.clamp(0, K - 1)
    match = (kv.gather(1, idx_c) == ku) & (ku != PAD)
    gathered = vv.gather(1, idx_c)
    return torch.where(match, vu * gathered,
                       torch.zeros((), dtype=vu.dtype,
                                   device=vu.device)).sum(dim=1)
