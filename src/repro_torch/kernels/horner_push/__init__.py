"""Horner-push kernel (Hopper), its plain version, the Horner loop and
backend resolution.

Backends for the single-source and top-k paths:

  * ``"kernel"`` -- ``horner_push_rows`` (and ``horner_push_slabs`` for
    a push over node slabs), which launch the Hopper kernel for CUDA
    tensors (and take the plain push only for tensors on the CPU);
  * ``"plain"``  -- ``horner_push_rows_plain`` (``horner_push_slabs_
    plain``) on any device (the CPU path, and the comparisons on the
    card);
  * ``"auto"``   -- resolves by device: ``"plain"`` on ``cpu``,
    ``"kernel"`` elsewhere (``cuda``, and the dry run's fake ``meta``
    devices, where the kernel's wrapper records its cost).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.horner_push.horner_push import (
    frontier_view, horner_push_rows, horner_push_rows_plain,
    horner_push_slabs, persistent_grid, slabs_grid, workspace_numel)
from repro_torch.kernels.horner_push.ops import (MAX_SEGMENTS, MAX_SLABS,
                                                 Slab, horner_push,
                                                 horner_push_slabs_plain,
                                                 horner_slab_step_plain,
                                                 horner_step_plain,
                                                 horner_steps_plain,
                                                 level_runs_plain,
                                                 prepare_rows, rows_by_owner,
                                                 top_level)

PUSH_BACKENDS = ("auto", "plain", "kernel")


def resolve_push_backend(name: str | None, device) -> str:
    """Resolve a backend name for tensors on ``device``."""
    name = name or "auto"
    if name not in PUSH_BACKENDS:
        raise ValueError(f"push backend {name!r} not in {PUSH_BACKENDS}")
    if name == "auto":
        return "plain" if torch.device(device).type == "cpu" else "kernel"
    return name


def push_for(backend: str):
    """The push function (row ids -> scores) a resolved backend drives."""
    return horner_push_rows if backend == "kernel" else \
        horner_push_rows_plain


__all__ = ["MAX_SEGMENTS", "MAX_SLABS", "PUSH_BACKENDS", "Slab",
           "frontier_view", "horner_push", "horner_push_rows",
           "horner_push_rows_plain", "horner_push_slabs",
           "horner_push_slabs_plain", "horner_slab_step_plain",
           "horner_step_plain", "horner_steps_plain", "level_runs_plain",
           "persistent_grid", "prepare_rows", "push_for",
           "resolve_push_backend", "rows_by_owner", "slabs_grid",
           "top_level", "workspace_numel"]
