"""Error-budget planner (Theorem 1), ported from ``repro/core/theory.py``.

With |d~_k - d_k| <= eps_d for all k and the Alg-2 HP error of
Lemma 7, every SimRank estimate satisfies |s~ - s| <= eps provided

    eps_d / (1 - c)  +  2*sqrt(c) * theta / ((1 - sqrt(c)) * (1 - c))  <=  eps.

``plan`` splits eps between the two terms exactly as the reference
does (paper Section 7.1: eps_d = 0.005, theta = 0.000725 at eps = 0.025,
c = 0.6) and reserves the walk-cap bias (sqrt c)^t_max inside eps_d.
``stale_frac`` reserves a share of eps for incremental maintenance
(``stale_increment`` charges each update batch against it) and
``eps_quant_frac`` a share for quantization (``quant_charge`` and the
per-entry bounds ``quant_vals_bound`` / ``quant_d_bound`` that
``core/quantize.py`` certifies against). Every field and bound equals
the reference's bit for bit: a v3 artifact's header is the plan as
JSON.
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
         walk_tail: float = 1e-4, stale_frac: float = 0.0,
         eps_quant_frac: float = 0.0) -> SlingPlan:
    """Choose (eps_d, theta, delta_d, t_max, l_max, n_r1) for a target eps.

    ``stale_frac`` reserves eps_stale = stale_frac * eps for incremental
    maintenance (``update_index`` spends it across batches until the
    rebuild trigger fires); ``eps_quant_frac`` reserves eps_quant =
    eps_quant_frac * eps for quantization (``quantize_index`` refuses
    without it). The static index is planned against
    eps_static = eps * (1 - stale_frac - eps_quant_frac).
    """
    if not (0 < eps < 1):
        raise ValueError("eps must be in (0,1)")
    if not (0 <= stale_frac < 1):
        raise ValueError("stale_frac must be in [0,1)")
    if not (0 <= eps_quant_frac < 1):
        raise ValueError("eps_quant_frac must be in [0,1)")
    if stale_frac + eps_quant_frac >= 1:
        raise ValueError(
            "stale_frac + eps_quant_frac reserve the whole eps budget; "
            "nothing is left for the static index")
    sc = math.sqrt(c)
    delta = delta if delta is not None else 1.0 / n
    eps_static = eps * (1 - stale_frac - eps_quant_frac)
    eps_d_raw = eps_d_frac * eps_static * (1 - c)
    theta = (1 - eps_d_frac) * eps_static * (1 - c) * (1 - sc) / (2 * sc)
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
                     walk_tail=tail, eps_stale=stale_frac * eps,
                     eps_quant=eps_quant_frac * eps)


def stale_increment(p: SlingPlan, theta_r: float, m_rows: float,
                    m_d: float) -> float:
    """Staleness charged against ``p.eps_stale`` by one update batch.

    ``m_rows``: the largest first-generation sub-threshold drift mass
    the row repair left uncaptured (``propagation_mass``'s skipped
    mass); ``m_d``: the largest mean in-neighbor drift proxy of a node
    whose d_k was not re-estimated. Each is amplified by the geometric
    descendant tail 1/(1 - sqrt c) and floored by theta_r (mass the
    propagation never materialises); the d channel enters scores
    through Theorem 1's d-term, c/(1 - c). Monotone and additive across
    batches: once the sum exceeds eps_stale the certificate is spent.
    """
    return (2.0 * (m_rows + theta_r) / (1.0 - p.sqrt_c)
            + 2.0 * p.c * (m_d + theta_r) / ((1 - p.c) * (1.0 - p.sqrt_c)))


def phase2_pairs_vec(mu_hat, eps_d: float, delta_d: float, c: float):
    """Alg 4 lines 12-13: total pair budgets n_r* for phase-1 estimates
    ``mu_hat`` (the same float64 expression tree as the reference)."""
    mu = np.asarray(mu_hat, np.float64)
    eps_star = eps_d / c
    mu_star = mu + np.sqrt(mu * eps_star)
    return np.ceil((2 * mu_star + (2.0 / 3.0) * eps_star)
                   / (eps_star ** 2)
                   * math.log(4.0 / delta_d)).astype(np.int64)


def phase2_pairs(mu_hat: float, eps_d: float, delta_d: float,
                 c: float) -> int:
    """Alg 4 lines 12-13: total pair budget n_r* for phase 2 (the scalar
    facade over :func:`phase2_pairs_vec`, so the two cannot drift)."""
    return int(phase2_pairs_vec(mu_hat, eps_d, delta_d, c))


# A pair score is a bilinear form in the stored vals with d~ in between.
# Per-entry errors b on vals and b_d on d~ cost at most
# 2b/(1 - sqrt c) (first order, |H(.)|_1 <= 1/(1 - sqrt c)),
# b^2/((1 - sqrt c) theta) (second order, Lemma 7's entry count) and
# b_d/(1 - c) (Theorem 1's d-term); single-source and top-k are batches
# of the same form.
def quant_charge(p: SlingPlan, b_vals: float, b_d: float = 0.0) -> float:
    """Worst-case additive score error from per-entry quantization
    bounds ``b_vals`` (HP vals) and ``b_d`` (diagonal)."""
    sc = p.sqrt_c
    return (2.0 * b_vals / (1.0 - sc)
            + b_vals * b_vals / ((1.0 - sc) * p.theta)
            + b_d / (1.0 - p.c))


def quant_vals_bound(p: SlingPlan, d_channel: bool = False) -> float:
    """Largest per-entry HP-val error whose ``quant_charge`` fits the
    plan's eps_quant reserve (half of it when ``d_channel`` leaves the
    other half to the diagonal): b = theta (sqrt(1 + budget (1 - sqrt c)
    / theta) - 1)."""
    if p.eps_quant <= 0:
        raise ValueError("plan reserved no quantization budget; "
                         "re-plan with eps_quant_frac > 0")
    budget = p.eps_quant * (0.5 if d_channel else 1.0)
    sc = p.sqrt_c
    return p.theta * (math.sqrt(1.0 + budget * (1.0 - sc) / p.theta)
                      - 1.0)


def quant_d_bound(p: SlingPlan) -> float:
    """Largest per-entry d~ error for the diagonal's half of the
    eps_quant reserve."""
    if p.eps_quant <= 0:
        raise ValueError("plan reserved no quantization budget; "
                         "re-plan with eps_quant_frac > 0")
    return 0.5 * p.eps_quant * (1.0 - p.c)


def alg1_pairs(eps_d: float, delta_d: float, c: float) -> int:
    """Alg 1 line 1: fixed pair budget (the unimproved estimator)."""
    return int(math.ceil((2 * c * c + c * eps_d) / (eps_d ** 2)
                         * math.log(2.0 / delta_d)))
