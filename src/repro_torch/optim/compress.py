"""Gradient compression with error feedback (port of
``repro/optim/compress.py``; optional, off by default).

bf16 compress-before-reduce halves the gradient traffic of a reduction
across replicas; the residual (float32 grad - bf16(grad)) is carried to
the next step, so the compression error telescopes instead of
accumulating (Seide et al. error feedback). Gradients and residuals are
{name: tensor} dicts, the names of ``adamw.named_leaves``.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import named_leaves


def init_residual(params) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named_leaves(params)}


def compress_with_feedback(grads: dict, residual: dict):
    """Returns (compressed bf16 grads to reduce, new residual)."""
    q, r = {}, {}
    for n, g in grads.items():
        corrected = g.to(torch.float32) + residual[n]
        q[n] = corrected.to(torch.bfloat16)
        r[n] = corrected - q[n].to(torch.float32)
    return q, r


def decompress(q: dict) -> dict[str, torch.Tensor]:
    return {n: g.to(torch.float32) for n, g in q.items()}
