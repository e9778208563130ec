"""Shared building blocks (port of ``repro/models/layers.py``; only
``dense_init`` so far, the rest comes with the models that use it)."""
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
