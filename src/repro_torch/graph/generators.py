"""Synthetic graph generators (host, NumPy).

Port of ``repro/graph/generators.py``: the same NumPy RNG calls in the
same order, so the same seed gives the same graph as the reference.
"""
from __future__ import annotations

import numpy as np

from . import csr


def erdos_renyi(n: int, m: int, seed: int = 0,
                directed: bool = True) -> csr.Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=int(m * 1.2), dtype=np.int64)
    dst = rng.integers(0, n, size=int(m * 1.2), dtype=np.int64)
    keep = src != dst
    src, dst = src[keep][:m], dst[keep][:m]
    if directed:
        return csr.from_edges(n, src, dst)
    return csr.undirected(n, src, dst)


def barabasi_albert(n: int, k: int = 4, seed: int = 0,
                    directed: bool = True) -> csr.Graph:
    """Preferential attachment; new node draws k targets ~ degree."""
    rng = np.random.default_rng(seed)
    targets = list(range(min(k, n)))
    src_l, dst_l = [], []
    repeated = list(targets)
    for v in range(len(targets), n):
        choice = rng.choice(len(repeated), size=min(k, len(repeated)),
                            replace=False)
        picks = {repeated[c] for c in choice}
        for t in picks:
            src_l.append(v)
            dst_l.append(t)
            repeated.append(t)
            repeated.append(v)
    src = np.array(src_l, dtype=np.int64)
    dst = np.array(dst_l, dtype=np.int64)
    if directed:
        flip = rng.random(len(src)) < 0.5
        return csr.from_edges(n, np.where(flip, dst, src),
                              np.where(flip, src, dst))
    return csr.undirected(n, src, dst)


def powerlaw_fast(n: int, k: int = 6, alpha: float = 2.2,
                  seed: int = 0) -> csr.Graph:
    """Heavy-tailed synthetic for the million-node scale path: ~n*k
    directed edges, sources uniform, destinations drawn from a
    bounded-Pareto popularity over node ids (in-degree tail exponent
    ~ ``alpha``). O(m) NumPy throughout, so 10^6-node graphs take
    seconds."""
    if alpha <= 1:
        raise ValueError("alpha must be > 1")
    rng = np.random.default_rng(seed)
    m = n * k
    src = rng.integers(0, n, size=m, dtype=np.int64)
    # inverse-CDF sample of a Pareto truncated to [1, n]: the rank of
    # the destination in the popularity order (rank 1 = hottest hub)
    u = rng.random(m)
    lo, s = 1.0, alpha - 1.0
    rank = (lo ** -s * (1 - u * (1 - (n / lo) ** -s))) ** (-1.0 / s)
    dst = np.minimum(rank.astype(np.int64) - 1, n - 1)
    keep = src != dst
    return csr.from_edges(n, src[keep], dst[keep])


def dag(n: int, m: int, seed: int = 0) -> csr.Graph:
    """Random DAG: edges point forward in a shuffled topological order."""
    rng = np.random.default_rng(seed)
    pos = np.empty(n, dtype=np.int64)
    pos[rng.permutation(n)] = np.arange(n)
    a = rng.integers(0, n, size=int(m * 1.5), dtype=np.int64)
    b = rng.integers(0, n, size=int(m * 1.5), dtype=np.int64)
    keep = a != b
    a, b = a[keep], b[keep]
    src = np.where(pos[a] < pos[b], a, b)[:m]
    dst = np.where(pos[a] < pos[b], b, a)[:m]
    return csr.from_edges(n, src, dst)


def with_sinks(n: int, m: int, n_sinks: int = 4,
               seed: int = 0) -> csr.Graph:
    """Sparse directed graph where ``n_sinks`` nodes keep in-degree 0."""
    rng = np.random.default_rng(seed)
    sinks = rng.choice(n, size=n_sinks, replace=False)
    src = rng.integers(0, n, size=int(m * 1.6), dtype=np.int64)
    dst = rng.integers(0, n, size=int(m * 1.6), dtype=np.int64)
    keep = (src != dst) & ~np.isin(dst, sinks)
    return csr.from_edges(n, src[keep][:m], dst[keep][:m])


def multigraph(n: int, m: int, seed: int = 0) -> csr.Graph:
    """Self-loop-free directed multigraph (parallel edges kept)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=2 * m, dtype=np.int64)
    dst = rng.integers(0, n, size=2 * m, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep][:m], dst[keep][:m]
    if m >= 2 and len(src) >= 2:
        src[-1], dst[-1] = src[0], dst[0]
    return csr.from_edges(n, src, dst, dedup=False)


def grid2d(rows: int, cols: int) -> csr.Graph:
    """4-neighbor undirected grid (mesh-GNN-like regular graph)."""
    n = rows * cols
    a_l, b_l = [], []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                a_l.append(v)
                b_l.append(v + 1)
            if r + 1 < rows:
                a_l.append(v)
                b_l.append(v + cols)
    return csr.undirected(n, np.array(a_l), np.array(b_l))


def cycle(n: int) -> csr.Graph:
    """Directed n-cycle: the Appendix-A adversarial case for Linearize
    (its Gauss-Seidel system matrix is not diagonally dominant at c=0.6)."""
    v = np.arange(n, dtype=np.int64)
    return csr.from_edges(n, v, (v + 1) % n)


def star(n: int) -> csr.Graph:
    """Hub node 0 with n-1 spokes, undirected. Extreme degree skew."""
    spokes = np.arange(1, n, dtype=np.int64)
    return csr.undirected(n, np.zeros(n - 1, dtype=np.int64), spokes)


# Table 3 of the paper: (n, m, directed) of the public graphs whose
# regimes the synthetic stand-ins match.
PAPER_GRAPHS = {
    "GrQc":      (5_242, 14_496, False),
    "AS":        (6_474, 13_895, False),
    "Wiki-Vote": (7_115, 103_689, True),
    "HepTh":     (9_877, 25_998, False),
    "Enron":     (36_692, 183_831, False),
}


def bipartite(n_users: int, n_items: int, m: int,
              seed: int = 0) -> csr.Graph:
    """User->item click graph, symmetrized (SimRank needs in-edges both
    ways); item popularity is power-law."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, size=m, dtype=np.int64)
    i = rng.zipf(1.5, size=m) % n_items
    return csr.undirected(n_users + n_items, u, n_users + i)


def paper_scale(name: str, seed: int = 0) -> csr.Graph:
    """Synthetic stand-ins matching Table 3's (n, m) regimes."""
    n, m, directed = PAPER_GRAPHS[name]
    return barabasi_albert(n, max(2, m // (n * (1 if directed else 2))),
                           seed=seed, directed=directed)
