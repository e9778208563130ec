"""Horner-push kernel (Hopper), its plain version, the Horner loop and
backend resolution.

Backends for the single-source and top-k paths:

  * ``"kernel"`` -- ``horner_push_rows``, which launches the Hopper
    kernel for CUDA tensors (and takes the plain push only for tensors
    on the CPU);
  * ``"plain"``  -- ``horner_push_rows_plain`` on any device (the CPU
    path, and the comparisons on the card);
  * ``"auto"``   -- resolves by device: ``"kernel"`` on ``cuda``,
    ``"plain"`` on ``cpu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.horner_push.horner_push import (
    horner_push_rows, horner_push_rows_plain, horner_push_slab_step,
    persistent_grid, workspace_numel)
from repro_torch.kernels.horner_push.ops import (horner_push,
                                                 horner_slab_step_plain,
                                                 horner_step_plain,
                                                 horner_steps_plain,
                                                 level_runs_plain,
                                                 prepare_rows, slab_rows)

PUSH_BACKENDS = ("auto", "plain", "kernel")


def resolve_push_backend(name: str | None, device) -> str:
    """Resolve a backend name for tensors on ``device``."""
    name = name or "auto"
    if name not in PUSH_BACKENDS:
        raise ValueError(f"push backend {name!r} not in {PUSH_BACKENDS}")
    if name == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "plain"
    return name


def push_for(backend: str):
    """The push function (row ids -> scores) a resolved backend drives."""
    return horner_push_rows if backend == "kernel" else \
        horner_push_rows_plain


__all__ = ["PUSH_BACKENDS", "horner_push", "horner_push_rows",
           "horner_push_rows_plain", "horner_push_slab_step",
           "horner_slab_step_plain", "horner_step_plain",
           "horner_steps_plain", "level_runs_plain", "persistent_grid",
           "prepare_rows", "push_for", "resolve_push_backend",
           "slab_rows", "workspace_numel"]
