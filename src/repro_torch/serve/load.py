"""Power-law (Zipf) query-load generation.

Port of ``repro/serve/load.py``: the same NumPy RNG calls, so the
arrays equal the reference's for the same seed.

Real SimRank query streams are heavily skewed -- a few hot nodes draw
most of the traffic (PRSim, PAPERS.md, measures exactly this shape on
real graphs). The serving benchmarks and the frontend cache tests
drive that distribution explicitly: node popularity follows a Zipf
law with exponent ``s`` (``s = 0`` degenerates to uniform), and the
rank->node assignment is a seeded permutation so "hot" does not just
mean "low id".
"""
from __future__ import annotations

import numpy as np


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Zipf(s) pmf over n ranks: p(rank r) ~ r^-s, r = 1..n."""
    if n < 1:
        raise ValueError("n must be >= 1")
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


def zipf_nodes(n: int, size: int, s: float = 1.0,
               seed: int = 0) -> np.ndarray:
    """``size`` node ids drawn Zipf(s) over ``n`` nodes (int32).

    Deterministic in ``seed``; the same seed also fixes the
    rank->node permutation, so streams with different exponents hit
    the *same* hot set -- cache hit-rate comparisons across ``s``
    measure skew, not which nodes happened to be popular.
    """
    rng = np.random.default_rng(seed)
    ranks_to_node = rng.permutation(n)
    draws = rng.choice(n, size=int(size), p=zipf_weights(n, s))
    return ranks_to_node[draws].astype(np.int32)
