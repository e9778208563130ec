"""The plain PyTorch version of one CIN layer (xDeepFM,
arXiv:1803.05170), as ``repro/kernels/cin/ref.py`` writes it:

x0 (B, m, D), xk (B, h, D), W (h', h, m):
    out[b, i, d] = sum_{a, j} W[i, a, j] * xk[b, a, d] * x0[b, j, d]

It materialises the (B, h, m, D) outer product: 160 MB a layer at
B = 512 and full width, so it serves the CPU tests and the comparisons
on the card, never the retrieval cell.

The layer's three gradients, for g = dL/dout (B, h', D):

    dxk[b, a, d] = sum_{i, j} W[i, a, j] * g[b, i, d] * x0[b, j, d]
    dx0[b, j, d] = sum_{i, a} W[i, a, j] * g[b, i, d] * xk[b, a, d]
    dW[i, a, j]  = sum_{b, d} g[b, i, d] * xk[b, a, d] * x0[b, j, d]

each as an outer product and one contraction, as the layer is written
(dx0 materialises (B, h', h, D): 6.5 GB at 4,096 rows and full width).
"""
from __future__ import annotations

import torch


def cin_layer_ref(x0: torch.Tensor, xk: torch.Tensor,
                  W: torch.Tensor) -> torch.Tensor:
    outer = torch.einsum("bhd,bmd->bhmd", xk, x0)
    return torch.einsum("bhmd,ihm->bid", outer, W)


def cin_grad_xk_plain(x0: torch.Tensor, W: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    outer = torch.einsum("bid,bjd->bijd", g, x0)
    return torch.einsum("bijd,iaj->bad", outer, W)


def cin_grad_x0_plain(xk: torch.Tensor, W: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    outer = torch.einsum("bid,bad->biad", g, xk)
    return torch.einsum("biad,iaj->bjd", outer, W)


def cin_grad_w_plain(x0: torch.Tensor, xk: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    outer = torch.einsum("bad,bjd->bajd", xk, x0)
    return torch.einsum("bid,bajd->iaj", g, outer)


def cin_layer_backward_plain(x0: torch.Tensor, xk: torch.Tensor,
                             W: torch.Tensor, g: torch.Tensor):
    """(dx0, dxk, dW) of one layer for the output's gradient g."""
    return (cin_grad_x0_plain(xk, W, g), cin_grad_xk_plain(x0, W, g),
            cin_grad_w_plain(x0, xk, g))
