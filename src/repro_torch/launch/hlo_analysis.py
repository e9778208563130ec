"""Collective traffic and roofline terms of a walked step (port of
``repro/launch/hlo_analysis.py``).

The reference parses compiled HLO for its collectives and models each
with a ring algorithm. The port has no compiler that partitions a
program: its collectives are the copies between devices that its own
single-controller code makes, which the op walk (``launch/hlo_walk.py``)
counts as they happen, each under the kind the code names. So
:func:`collective_stats` reads the walk's records, not HLO text, and
:func:`analyze_cell` takes the walk's totals where the reference's
``analyze_compiled`` took a compiled executable.

Hardware model: one NVIDIA H100 SXM at its 700 W power limit, the data
sheet's peaks (``kernels/cost.py``): 989 TFLOP/s dense bf16 / fp16 (the
MFU denominator), 494.7 TFLOP/s TF32 and 67 TFLOP/s float32 (a
product's time is taken at its own dtype's rate by the walk), 3.35 TB/s
of HBM, and NVLink at 450 GB/s each way.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict

from repro_torch.kernels import cost as _cost

PEAK_FLOPS = _cost.BF16_OPS_PER_S     # dense bf16 / chip
HBM_BW = _cost.HBM_BYTES_PER_S        # bytes/s per chip
NVLINK_BW = _cost.NVLINK_BYTES_PER_S  # bytes/s per chip, each way


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict
    total_bytes: float           # bytes received by one device

    def summary(self) -> str:
        parts = [f"{k}:{v / 1e6:.1f}MB(x{self.count_by_op[k]})"
                 for k, v in sorted(self.bytes_by_op.items())]
        return " ".join(parts) or "none"


def collective_stats(records, device: str | None = None) -> CollectiveStats:
    """Bytes and copies by kind that ``device`` received, from the op
    walk's records (the device that received the most when None)."""
    recv: dict = defaultdict(float)
    for r in records:
        if r.kind is not None:
            recv[r.device] += r.nbytes
    if device is None:
        device = max(recv, key=recv.get, default=None)
    bytes_by_op: dict = defaultdict(float)
    count_by_op: Counter = Counter()
    for r in records:
        if r.kind is not None and r.device == device:
            bytes_by_op[r.kind] += r.nbytes
            count_by_op[r.kind] += 1
    return CollectiveStats(dict(bytes_by_op), dict(count_by_op),
                           float(sum(bytes_by_op.values())))


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    n_devices: int
    model_flops: float
    # memory footprint
    arg_bytes: float = 0.0
    temp_bytes: float = 0.0
    out_bytes: float = 0.0
    # seconds of the products at each one's own dtype rate (the walk's);
    # keyword-only, so that the reference's eight positional fields read
    # as the reference reads them
    compute_s_per_device: float = dataclasses.field(kw_only=True)

    @property
    def t_compute(self) -> float:
        return self.compute_s_per_device

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (total walked FLOPs) -- remat/redundancy waste."""
        tot = self.flops_per_device * self.n_devices
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_time * PEAK_FLOPS * self.n_devices
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "flops/dev": self.flops_per_device,
            "hbm_bytes/dev": self.hbm_bytes_per_device,
            "coll_bytes/dev": self.coll_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_mfu": self.mfu,
            "arg_bytes/dev": self.arg_bytes,
            "temp_bytes/dev": self.temp_bytes,
        }


def analyze_cell(walk, model_flops: float, n_devices: int,
                 memory: dict) -> Roofline:
    """Roofline terms of a step from its op walk (``hlo_walk.
    WalkTotals``, the busiest device's), ``memory`` the dry run's bytes
    per device ("argument", "temp", "output")."""
    return Roofline(flops_per_device=walk.flops,
                    hbm_bytes_per_device=walk.hbm_bytes,
                    coll_bytes_per_device=walk.coll_bytes,
                    n_devices=n_devices, model_flops=model_flops,
                    compute_s_per_device=walk.compute_s,
                    arg_bytes=float(memory.get("argument", 0)),
                    temp_bytes=float(memory.get("temp", 0)),
                    out_bytes=float(memory.get("output", 0)))
