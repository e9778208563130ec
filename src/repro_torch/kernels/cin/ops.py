"""The CIN stack over the layer wrapper (port of
``repro/kernels/cin/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cin.cin import cin_layer
from repro_torch.kernels.cin.ref import cin_layer_ref


def cin_forward(x0: torch.Tensor, weights, *, backend: str = "auto"
                ) -> torch.Tensor:
    """x0 (B, m, D); weights: list of (h_k, h_{k-1}, m). Returns the
    (B, sum h_k) sum-pooled CIN features, each layer through
    :func:`cin_layer` (the Hopper kernel on the card). ``backend`` is
    keyword-only: the reference's third positional is ``bb``, a Pallas
    block size the port has no use for, so its call ``cin_forward(x0,
    w, 64)`` raises ``TypeError``."""
    xk = x0
    pooled = []
    for W in weights:
        xk = cin_layer(x0, xk, W, backend=backend)
        pooled.append(xk.sum(-1))
    return torch.cat(pooled, dim=-1)


def cin_forward_reference(x0: torch.Tensor, weights) -> torch.Tensor:
    """The same stack on the plain layer."""
    xk = x0
    pooled = []
    for W in weights:
        xk = cin_layer_ref(x0, xk, W)
        pooled.append(xk.sum(-1))
    return torch.cat(pooled, dim=-1)
