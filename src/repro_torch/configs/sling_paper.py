"""The paper's own configuration (not one of the assigned archs): SLING
at eps=0.025, c=0.6, eps_d=0.005, theta=0.000725, delta_d=1/n^2 (paper
Section 7.1). The "sling-serve" pseudo-arch is the batched single-source
query (Algorithm 6, Horner-stacked) as a serving cell:
``train.steps.sling_serve_step``.

Port of ``repro/configs/sling_paper.py``, the same field values.
"""
import dataclasses

from repro_torch.configs import base


@dataclasses.dataclass(frozen=True)
class SlingServeConfig:
    name: str = "sling-serve"
    n: int = 1_000_000          # graph nodes
    m: int = 16_000_000         # graph edges
    hp_width: int = 64          # packed H(v) row width
    batch: int = 1024           # single-source queries per step
    l_max: int = 12             # Horner push depth
    eps: float = 0.025
    c: float = 0.6


def full() -> SlingServeConfig:
    return SlingServeConfig()


def smoke() -> SlingServeConfig:
    return SlingServeConfig(name="sling-serve-smoke", n=500, m=2000,
                            hp_width=16, batch=8, l_max=6)


base.register(base.ArchSpec(
    arch_id="sling-serve", family="sling", full=full, smoke=smoke,
    shapes=("serve_batch",),
    notes="the paper's technique as a serving cell (extra, not in the 40)"))
