"""Linearization baseline (Maehara et al., paper Sections 3.3 / Appendix A).

Port of ``repro/baselines/linearize.py``. S = c P^T S P + D with D the
diagonal correction matrix; given D,
s(u,v) = sum_l c^l (P^l e_u)^T D (P^l e_v)   (Eq. 9, truncated at T).

Preprocessing estimates p~^(l)_{k,i} (reverse-walk occupancy) with R
walks truncated at T steps, assembles the linear system
sum_{l,i} c^l (p~^(l)_{k,i})^2 D(i,i) = 1 (Eq. 19) and runs L
Gauss-Seidel sweeps. Defaults follow the paper's recommendation
T = 11, R = 100, L = 3 at c = 0.6.

This method has NO worst-case accuracy guarantee (the paper's central
criticism): the system matrix need not be diagonally dominant (the
directed 4-cycle of Appendix A/Figure 8 violates it at c = 0.6 --
``system_matrix_dd_margin`` exposes this) and Gauss-Seidel may not
converge.

Everything is float64. The walks draw on the host with the reference's
NumPy calls, so their positions are the reference's; the dense (n, n)
occupancy and system matrices and the queries' products by P and P^T
run on the device (``cuda`` unless ``device="cpu"``), the reference's
``np.add.at`` scatters as ``index_add_``. An occupancy is a count of
walks scaled by 1/R once (the reference adds 1/R a walk), and the
scatters' atomics reorder float64 sums on the card, so answers agree
with the reference's to float64 rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import csr


@dataclasses.dataclass
class LinearizeIndex:
    c: float
    T: int
    D: torch.Tensor  # (n,) float64 diagonal of the correction matrix
    _: dataclasses.KW_ONLY
    # per graph queried: its edges on D's device (_edges)
    edges: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)


def _edges(lin: LinearizeIndex, g: csr.Graph):
    """The graph's edges on ``lin.D``'s device -- src, dst (int64) and
    |I(dst)| (float64, at least 1) per edge -- kept in ``lin`` for the
    next query of the same graph (a graph is known by its edge array,
    held, so a reused id cannot match)."""
    hit = lin.edges.get(id(g))
    if hit is None or hit[0] is not g.edge_src:
        deg = np.maximum(g.in_deg, 1).astype(np.float64)
        hit = lin.edges[id(g)] = (g.edge_src, tuple(
            torch.as_tensor(a, device=lin.D.device) for a in (
                g.edge_src.astype(np.int64), g.edge_dst.astype(np.int64),
                deg[g.edge_dst])))
    return hit[1]


def _p_matvec(edges, x: torch.Tensor) -> torch.Tensor:
    """y = P x: y[i] = sum_{j: edge i->j} x[j] / |I(j)| (x (n,) or (n, k))."""
    src, dst, deg = edges
    return torch.zeros_like(x).index_add_(
        0, src, x[dst] / deg.view(-1, *([1] * (x.dim() - 1))))


def _pt_matvec(edges, x: torch.Tensor) -> torch.Tensor:
    """y = P^T x: y[j] = (1/|I(j)|) sum_{i in I(j)} x[i] (x (n,))."""
    src, dst, deg = edges
    return torch.zeros_like(x).index_add_(0, dst, x[src] / deg)


def estimate_occupancies(g: csr.Graph, T: int, R: int, seed: int = 0, *,
                         device=None) -> list:
    """p~^(l)_{k,i} via R truncated reverse walks per node: a list over
    l = 0 .. T of dense (n, n) float64 matrices on ``device`` (dense: the
    baseline runs on small graphs, as in the paper's Fig 5-7)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = g.n
    deg = g.in_deg.astype(np.int64)
    in_ptr = g.in_ptr.astype(np.int64)
    pos = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, R))
    alive = deg[pos] > 0
    out = [torch.eye(n, dtype=torch.float64, device=dev)]
    rows = torch.arange(n, device=dev).repeat_interleave(R) * n
    for _ in range(1, T + 1):
        d = deg[pos]
        r = rng.integers(0, np.maximum(d, 1))
        nxt = g.in_idx[np.minimum(in_ptr[pos] + r, max(g.m - 1, 0))]
        pos = np.where(alive, nxt, pos)
        alive = alive & (deg[pos] > 0)
        occupied = torch.as_tensor(alive.ravel(), device=dev)
        cell = rows + torch.as_tensor(pos.ravel(), device=dev)
        count = torch.bincount(cell[occupied], minlength=n * n)
        out.append((count.to(torch.float64) / R).view(n, n))
    return out


def system_matrix(g: csr.Graph, c: float, T: int, R: int | None,
                  seed: int = 0, *, device=None) -> torch.Tensor:
    """M(k,i) = sum_l c^l (p^(l)_{k,i})^2 on ``device``. R=None -> exact
    occupancies (powers of ``power.transition_dense``)."""
    dev = resolve_device(device)
    n = g.n
    M = torch.zeros((n, n), dtype=torch.float64, device=dev)
    if R is None:
        from repro_torch.baselines import power
        W = torch.as_tensor(power.transition_dense(g), device=dev)
        P_l = torch.eye(n, dtype=torch.float64, device=dev)
        for l in range(T + 1):
            M += (c ** l) * P_l ** 2
            if l + 1 <= T:
                P_l = W @ P_l
        return M
    for l, p in enumerate(estimate_occupancies(g, T, R, seed, device=dev)):
        M += (c ** l) * p ** 2
    return M


def system_matrix_dd_margin(M) -> float:
    """min_i (|M_ii| - sum_{j != i} |M_ij|); negative = not diagonally
    dominant (Appendix A's failure condition)."""
    M = torch.as_tensor(M)
    diag = M.diagonal().abs()
    return float((diag - (M.abs().sum(dim=1) - diag)).min())


def gauss_seidel(M, iters: int = 3) -> tuple[torch.Tensor, float]:
    """L sweeps of Gauss-Seidel for M D = 1, in the reference's row
    order. Returns (D on M's device, residual).

    The sweeps run on the host: row i's update reads the rows before it
    updated in the same sweep, so on the card a sweep would be n
    dependent launches of a length-n dot product, each waiting for the
    last; on the host each is a NumPy dot, and M crosses once."""
    M = torch.as_tensor(M)
    A = M.cpu().numpy()
    n = A.shape[0]
    D = np.zeros(n)
    for _ in range(iters):
        for i in range(n):
            off = A[i] @ D - A[i, i] * D[i]
            D[i] = (1.0 - off) / max(A[i, i], 1e-12)
    resid = float(np.abs(A @ D - 1.0).max())
    return torch.as_tensor(D, device=M.device), resid


def build(g: csr.Graph, c: float = 0.6, T: int = 11, R: int | None = 100,
          L: int = 3, seed: int = 0, *, device=None) -> LinearizeIndex:
    M = system_matrix(g, c, T, R, seed, device=device)
    D, _ = gauss_seidel(M, iters=L)
    return LinearizeIndex(c=c, T=T, D=D)


def query_pair(lin: LinearizeIndex, g: csr.Graph, u: int, v: int) -> float:
    """Eq. 9 for one pair: e_u and e_v pushed through P together, on the
    device ``lin.D`` lies on."""
    if u == v:
        return 1.0
    edges = _edges(lin, g)
    x = torch.zeros((g.n, 2), dtype=torch.float64, device=lin.D.device)
    x[u, 0] = 1.0
    x[v, 1] = 1.0
    s = torch.zeros((), dtype=torch.float64, device=x.device)
    for l in range(lin.T + 1):
        s += (lin.c ** l) * (x[:, 0] * lin.D * x[:, 1]).sum()
        if l < lin.T:
            x = _p_matvec(edges, x)
    return float(s)


def query_single_source(lin: LinearizeIndex, g: csr.Graph,
                        u: int) -> np.ndarray:
    """S[:, u] = sum_l c^l (P^T)^l D P^l e_u, Horner-stacked."""
    edges = _edges(lin, g)
    x = torch.zeros(g.n, dtype=torch.float64, device=lin.D.device)
    x[u] = 1.0
    us = [x]
    for _ in range(lin.T):
        us.append(_p_matvec(edges, us[-1]))
    acc = lin.D * us[lin.T]
    for l in range(lin.T - 1, -1, -1):
        acc = lin.D * us[l] + lin.c * _pt_matvec(edges, acc)
    acc[u] = 1.0
    return acc.cpu().numpy()
