"""Power method (paper Section 3.1): all-pairs ground truth (host, NumPy).

Port of ``repro/baselines/power.py``. S <- c * W S W^T with the
diagonal forced to 1, W(i, u) = mult(u -> i)/|I(i)|. Dense O(n^2), for
small graphs only: ``diagonal.exact_diagonal`` and the accuracy checks
use it.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.graph import csr


def transition_dense(g: csr.Graph) -> np.ndarray:
    """W(i, u) = mult(u -> i)/|I(i)| (parallel edges accumulate)."""
    W = np.zeros((g.n, g.n), dtype=np.float64)
    deg = g.in_deg
    for v in range(g.n):
        if deg[v]:
            np.add.at(W[v], g.in_neighbors(v), 1.0 / deg[v])
    return W


def iterations_for(eps: float, c: float) -> int:
    """Lemma 1 bound."""
    return max(1, int(math.ceil(math.log(eps * (1 - c)) / math.log(c) - 1)))


def all_pairs(g: csr.Graph, c: float = 0.6, iters: int = 50) -> np.ndarray:
    W = transition_dense(g)
    S = np.eye(g.n, dtype=np.float64)
    for _ in range(iters):
        S = c * (W @ S @ W.T)
        np.fill_diagonal(S, 1.0)
    return S
