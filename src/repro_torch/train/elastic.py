"""Elastic scaling + straggler mitigation (port of
``repro/train/elastic.py``).

  * **Checkpoint/restart** -- train loops checkpoint every
    ``ckpt_every`` steps through train/checkpoint.py (atomic,
    mesh-agnostic); the data pipeline is step-keyed so a restart
    replays bit-identically.
  * **Elastic re-mesh** -- ``remesh(n_devices, model_axis, ...)``
    plans the largest (data, model) mesh that fits the surviving
    devices; shrinking the data axis keeps the global batch by raising
    gradient accumulation. ``make_mesh_from_plan`` builds it as a
    ``launch.mesh.Mesh``.
  * **Straggler mitigation** -- ``DEFAULT_TIMEOUTS`` are the launcher's
    collective, heartbeat and barrier limits; on a cluster they map to
    ``torch.distributed`` options (``init_process_group(timeout=)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.launch.mesh import Mesh, make_debug_mesh


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    grad_accum: int
    dropped_devices: int


def remesh(n_devices: int, model_axis: int, global_batch: int,
           prev_data_axis: int) -> ElasticPlan:
    """Largest (data, model) mesh on the surviving devices with the same
    model axis (the tensor-parallel degree is a property of the
    checkpointed layout); with fewer devices than the model axis, the
    model axis shrinks to the largest power of two that fits."""
    if n_devices < model_axis:
        model_axis = max(1, 2 ** int(math.floor(math.log2(n_devices))))
    data_axis = max(1, n_devices // model_axis)
    used = data_axis * model_axis
    # keep the global batch: accumulate the lost data parallelism
    accum = max(1, int(math.ceil(prev_data_axis / data_axis)))
    return ElasticPlan(mesh_shape=(data_axis, model_axis),
                       axis_names=("data", "model"),
                       grad_accum=accum,
                       dropped_devices=n_devices - used)


def make_mesh_from_plan(plan: ElasticPlan, devices: Sequence = None) -> Mesh:
    """The plan's mesh over the first devices of ``devices`` (by default
    the first CUDA devices; a device may repeat, as ``["cpu"] * 4``)."""
    need = plan.mesh_shape[0] * plan.mesh_shape[1]
    if devices is not None:
        devices = list(devices)[:need]
    return make_debug_mesh(plan.mesh_shape, plan.axis_names, devices=devices)


# Collective / straggler timeouts: on a cluster these map to the
# distributed runtime's options; surfaced here as launcher config.
DEFAULT_TIMEOUTS = {
    "collective_timeout_s": 300.0,   # flag a straggling host
    "heartbeat_interval_s": 10.0,
    "barrier_timeout_s": 600.0,      # checkpoint-boundary barrier
}
