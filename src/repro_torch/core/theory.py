"""Error-budget planner (Theorem 1), ported from ``repro/core/theory.py``.

With |d~_k - d_k| <= eps_d for all k and the Alg-2 HP error of
Lemma 7, every SimRank estimate satisfies |s~ - s| <= eps provided

    eps_d / (1 - c)  +  2*sqrt(c) * theta / ((1 - sqrt(c)) * (1 - c))  <=  eps.

``plan`` splits eps between the two terms exactly as the reference
does (paper Section 7.1: eps_d = 0.005, theta = 0.000725 at eps = 0.025,
c = 0.6) and reserves the walk-cap bias (sqrt c)^t_max inside eps_d.
The reference's staleness and quantization reserves are not part of
this slice; their plan fields stay (at 0) so plans carry across.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SlingPlan:
    c: float
    eps: float
    delta: float
    eps_d: float          # additive error allowed in each d_k
    theta: float          # HP prune threshold (Alg 2)
    delta_d: float        # per-node failure probability
    t_max: int            # walk step cap
    l_max: int            # max HP step: (sqrt c)^l <= theta
    n_r1: int             # Alg 4 phase-1 pair count
    walk_tail: float      # (sqrt c)^t_max
    eps_stale: float = 0.0
    eps_quant: float = 0.0

    @property
    def sqrt_c(self) -> float:
        return math.sqrt(self.c)

    def error_bound(self) -> float:
        """LHS of Theorem 1's condition (must be <= eps)."""
        sc = self.sqrt_c
        return (self.eps_d / (1 - self.c)
                + 2 * sc * self.theta / ((1 - sc) * (1 - self.c)))

    def hp_entry_bound(self) -> int:
        """Lemma 7: |H(v)| <= sum_l (sqrt c)^l / theta = O(1/theta)."""
        return int(math.ceil(1.0 / ((1 - self.sqrt_c) * self.theta)))


def plan(eps: float = 0.025, delta: float | None = None, c: float = 0.6,
         n: int = 1 << 20, eps_d_frac: float = 0.5,
         walk_tail: float = 1e-4) -> SlingPlan:
    """Choose (eps_d, theta, delta_d, t_max, l_max, n_r1) for a target eps."""
    if not (0 < eps < 1):
        raise ValueError("eps must be in (0,1)")
    sc = math.sqrt(c)
    delta = delta if delta is not None else 1.0 / n
    eps_d_raw = eps_d_frac * eps * (1 - c)
    theta = (1 - eps_d_frac) * eps * (1 - c) * (1 - sc) / (2 * sc)
    t_max = max(1, int(math.ceil(math.log(walk_tail) / math.log(sc))))
    tail = sc ** t_max
    eps_d = eps_d_raw - c * tail
    if eps_d <= 0:
        raise ValueError("walk tail consumed the whole eps_d budget; "
                         "raise eps or lower walk_tail")
    delta_d = delta / max(n, 1)
    l_max = max(1, int(math.ceil(math.log(theta) / math.log(sc))))
    eps_star = eps_d / c
    n_r1 = int(math.ceil(14.0 / (3.0 * eps_star) * math.log(4.0 / delta_d)))
    return SlingPlan(c=c, eps=eps, delta=delta, eps_d=eps_d, theta=theta,
                     delta_d=delta_d, t_max=t_max, l_max=l_max, n_r1=n_r1,
                     walk_tail=tail)


def phase2_pairs_vec(mu_hat, eps_d: float, delta_d: float, c: float):
    """Alg 4 lines 12-13: total pair budgets n_r* for phase-1 estimates
    ``mu_hat`` (the same float64 expression tree as the reference)."""
    mu = np.asarray(mu_hat, np.float64)
    eps_star = eps_d / c
    mu_star = mu + np.sqrt(mu * eps_star)
    return np.ceil((2 * mu_star + (2.0 / 3.0) * eps_star)
                   / (eps_star ** 2)
                   * math.log(4.0 / delta_d)).astype(np.int64)


def alg1_pairs(eps_d: float, delta_d: float, c: float) -> int:
    """Alg 1 line 1: fixed pair budget (the unimproved estimator)."""
    return int(math.ceil((2 * c * c + c * eps_d) / (eps_d ** 2)
                         * math.log(2.0 / delta_d)))
