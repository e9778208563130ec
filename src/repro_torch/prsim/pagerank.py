"""Reverse PageRank: the hub-ranking pass of the prsim builder.

Port of ``repro/prsim/pagerank.py``. PageRank on the transposed graph:
a surfer at v follows a uniformly random *in*-edge of v, which is the
stationary bias of SimRank's backward sqrt(c)-walks, so high reverse-PR
nodes are the columns most walks hit. Each iteration is one float32
step on the device (a gather, ``index_add_`` and the dangling mass);
convergence is checked on the host between steps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import csr

DEFAULT_DAMPING = 0.85
DEFAULT_TOL = 1e-6        # L1 residual on a distribution summing to 1
MAX_ITERS = 100


def _pr_step(pr, d_nbr, d_owner, d_inv, d_dang, damping: float):
    """One reverse-PageRank step on the device: (the next iterate, its
    L1 residual against ``pr`` as a 0-d tensor). Edge e carries
    ``pr[d_owner[e]] * d_inv[e]`` to ``d_nbr[e]``; ``d_dang`` marks the
    in-degree-0 owners, whose mass spreads uniformly."""
    n = pr.shape[0]
    agg = torch.zeros(n, dtype=torch.float32, device=pr.device)
    agg.index_add_(0, d_nbr, pr[d_owner] * d_inv)
    loose = (pr * d_dang).sum()
    new = (1.0 - damping) / n + damping * (agg + loose / n)
    return new, (new - pr).abs().sum()


def reverse_pagerank(g: csr.Graph, damping: float = DEFAULT_DAMPING,
                     tol: float = DEFAULT_TOL,
                     max_iters: int = MAX_ITERS,
                     edge_cap: int | None = None, device=None
                     ) -> tuple[np.ndarray, int]:
    """Reverse-PageRank scores of every node on ``device`` (``cuda``
    unless ``device="cpu"``). Returns ``(pr, iters)``: a float32 host
    probability vector and the steps until the L1 residual fell under
    ``tol`` (or ``max_iters``).

    Edge e of owner v carries ``pr[v] / |I(v)|`` to ``in_idx[e]``, an
    in-neighbour of v; the mass of in-degree-0 owners spreads uniformly,
    so the iterate stays a distribution. ``edge_cap`` is the
    reference's edge bucket: below m it is refused. The port pads
    nothing (the reference pads to the bucket only to reuse a compiled
    XLA program)."""
    n, m = g.n, g.m
    if n == 0:
        return np.zeros(0, np.float32), 0
    if edge_cap is not None and edge_cap < m:
        raise ValueError(f"edge_cap {edge_cap} < m {m}")
    dev = resolve_device(device)
    deg = g.in_deg.astype(np.int64)
    owner = np.repeat(np.arange(n, dtype=np.int64), deg)
    inv_deg = (1.0 / np.maximum(deg, 1))[owner].astype(np.float32)
    d_owner = torch.as_tensor(owner, device=dev)
    d_nbr = torch.as_tensor(g.in_idx.astype(np.int64), device=dev)
    d_inv = torch.as_tensor(inv_deg, device=dev)
    d_dang = torch.as_tensor((deg == 0).astype(np.float32), device=dev)
    pr = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    iters = 0
    for iters in range(1, max_iters + 1):
        new, resid = _pr_step(pr, d_nbr, d_owner, d_inv, d_dang, damping)
        resid = float(resid)
        pr = new
        if resid <= tol:
            break
    return pr.cpu().numpy(), iters
