"""Degree-skew measurement for builder selection (host, NumPy).

Port of ``repro/graph/stats.py`` (DESIGN.md §15), the same arithmetic
in the same order, so the choice and ``SkewStats.as_row()`` equal the
reference's. PRSim's hub decomposition pays off on graphs whose
in-degree has a heavy Pareto tail; ``build_index(builder="auto")``
measures the tail before it picks a backend:

  * :func:`hill_alpha` -- the Hill estimator of the CCDF tail exponent
    ``alpha`` (P[D > x] ~ x^-alpha) over the top-k in-degree order
    statistics; Poisson (Erdos-Renyi) in-degrees send it upward;
  * :func:`top_mass` -- the share of the in-degree mass held by the top
    ``ceil(frac * n)`` nodes.

:func:`choose_builder` picks "prsim" iff the tail is measurably Pareto
and the hubs concentrate the mass. A wrong "prsim" costs no
correctness: both builders emit the same certified entries.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.graph import csr

# selection contract (DESIGN.md §15): prsim iff both hold
ALPHA_MAX = 3.0          # Hill tail exponent: Pareto-ish tails only
CONCENTRATION_MIN = 4.0  # top-mass share must be >= 4x the node share
HUB_FRAC = 0.05          # "top nodes" = top ceil(HUB_FRAC * n) by in-deg


@dataclasses.dataclass(frozen=True)
class SkewStats:
    """Measured in-degree skew of one graph (see the module docstring)."""
    n: int
    m: int
    alpha: float        # Hill tail exponent (inf = no Pareto tail)
    top_frac: float     # node share of the measured top set
    top_mass: float     # in-degree mass share of that top set
    score: float        # concentration ratio: top_mass / top_frac

    def as_row(self) -> dict:
        return {"n": self.n, "m": self.m,
                "alpha": (None if math.isinf(self.alpha)
                          else round(self.alpha, 4)),
                "top_frac": round(self.top_frac, 6),
                "top_mass": round(self.top_mass, 6),
                "score": round(self.score, 4)}


def hill_alpha(deg: np.ndarray, k: int | None = None) -> float:
    """Hill estimator of the CCDF tail exponent over the top-k order
    statistics of ``deg`` (zeros excluded). ``inf`` when the tail is
    degenerate (fewer than 8 positive degrees, or the top-k all tie)."""
    d = np.asarray(deg, np.float64)
    d = d[d > 0]
    if d.size < 8:
        return float("inf")
    d = np.sort(d)[::-1]
    if k is None:
        # sqrt-k rule: enough order statistics for a stable estimate,
        # few enough to stay inside the tail
        k = int(np.clip(math.isqrt(d.size), 8, d.size - 1))
    k = min(k, d.size - 1)
    logs = np.log(d[:k] / d[k])
    s = float(logs.sum())
    if s <= 0.0:
        return float("inf")
    return k / s


def top_mass(deg: np.ndarray, frac: float = HUB_FRAC) -> tuple[float, float]:
    """(node share, mass share) of the top ``ceil(frac * n)`` nodes by
    degree: the mass a hub set of that size would cover."""
    d = np.asarray(deg, np.float64)
    total = float(d.sum())
    if d.size == 0 or total <= 0:
        return 0.0, 0.0
    k = max(1, int(math.ceil(frac * d.size)))
    top = np.partition(d, d.size - k)[d.size - k:]
    return k / d.size, float(top.sum()) / total


def measure_skew(g: csr.Graph, frac: float = HUB_FRAC) -> SkewStats:
    """In-degree skew of ``g``: O(n log n) on the host."""
    alpha = hill_alpha(g.in_deg)
    top_frac, mass = top_mass(g.in_deg, frac=frac)
    score = mass / top_frac if top_frac > 0 else 0.0
    return SkewStats(n=g.n, m=g.m, alpha=alpha, top_frac=top_frac,
                     top_mass=mass, score=score)


def choose_builder(g: csr.Graph) -> tuple[str, SkewStats]:
    """The ``builder="auto"`` contract: "prsim" iff ``hill_alpha <=
    ALPHA_MAX`` and the top-``HUB_FRAC`` nodes hold at least
    ``CONCENTRATION_MIN`` times their node share of the in-degree mass,
    else "sling"; with the measured stats."""
    stats = measure_skew(g)
    skewed = (stats.alpha <= ALPHA_MAX
              and stats.score >= CONCENTRATION_MIN)
    return ("prsim" if skewed else "sling"), stats
