"""Horner-push step kernel (Hopper), its plain version, the CSR layout,
the Horner loop and backend resolution.

Backends for the single-source and top-k paths:

  * ``"kernel"`` -- the Horner loop calls the steps wrapper, which launches
    the Hopper kernel for CUDA tensors (and takes the plain steps only
    for tensors on the CPU);
  * ``"plain"``  -- the Horner loop calls the plain PyTorch steps on any
    device (the CPU path, and the comparisons on the card);
  * ``"auto"``   -- resolves by device: ``"kernel"`` on ``cuda``,
    ``"plain"`` on ``cpu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.horner_push.horner_push import (horner_steps,
                                                         horner_steps_plain)
from repro_torch.kernels.horner_push.ops import horner_push, prepare_rows

PUSH_BACKENDS = ("auto", "plain", "kernel")


def resolve_push_backend(name: str | None, device) -> str:
    """Resolve a backend name for tensors on ``device``."""
    name = name or "auto"
    if name not in PUSH_BACKENDS:
        raise ValueError(f"push backend {name!r} not in {PUSH_BACKENDS}")
    if name == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "plain"
    return name


def steps_for(backend: str):
    """The steps function a resolved backend drives."""
    return horner_steps if backend == "kernel" else horner_steps_plain


__all__ = ["PUSH_BACKENDS", "horner_push", "horner_steps",
           "horner_steps_plain", "prepare_rows", "resolve_push_backend",
           "steps_for"]
