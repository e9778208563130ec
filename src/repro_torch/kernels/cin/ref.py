"""The plain PyTorch version of one CIN layer (xDeepFM,
arXiv:1803.05170), as ``repro/kernels/cin/ref.py`` writes it:

x0 (B, m, D), xk (B, h, D), W (h', h, m):
    out[b, i, d] = sum_{a, j} W[i, a, j] * xk[b, a, d] * x0[b, j, d]

It materialises the (B, h, m, D) outer product: 160 MB a layer at
B = 512 and full width, so it serves the CPU tests and the comparisons
on the card, never the retrieval cell.
"""
from __future__ import annotations

import torch


def cin_layer_ref(x0: torch.Tensor, xk: torch.Tensor,
                  W: torch.Tensor) -> torch.Tensor:
    outer = torch.einsum("bhd,bmd->bhmd", xk, x0)
    return torch.einsum("bhmd,ihm->bid", outer, W)
