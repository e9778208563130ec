"""Single-source SimRank queries: Alg 6 and its Horner form.

Port of ``repro/core/single_source.py``. The answer sum_l Â^l seed_l
(seed_l[k] = h~^(l)(u, k) * d_k) is computed Horner-stacked,

    acc = seed_L;  for l = L-1 .. 0:  acc = Â prune_tau(acc) + seed_l,

with tau = (sqrt c)^L * theta (:func:`prune_tau`), the smallest of
Alg 6's per-group thresholds.

  * ``single_source_paper`` / ``single_source_horner`` -- host float64
    references (NumPy);
  * ``horner_push`` -- the plain PyTorch push over a batch of rows;
  * ``batched_single_source`` -- (B,) query ids -> (B, n) scores through
    the chosen backend: the Hopper step kernel on ``cuda``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph import csr
from repro_torch.kernels import horner_push as hpk


def prune_tau(plan) -> float:
    """The Horner prune threshold tau = (sqrt c)^l_max * theta."""
    return float(plan.theta * plan.sqrt_c ** plan.l_max)


def _seed_matrix(idx, u: int) -> np.ndarray:
    """(L+1, n) float64: seeds[l, k] = h~^(l)(u,k) * d_k (duplicate keys
    add up)."""
    n = idx.n
    c = int(idx.hp.counts[u])
    keys = idx.hp.keys[u, :c].cpu().numpy().astype(np.int64)
    vals = idx.hp.vals[u, :c].cpu().numpy().astype(np.float64)
    d = idx.d.cpu().numpy().astype(np.float64)
    seeds = np.zeros((idx.plan.l_max + 1, n), dtype=np.float64)
    np.add.at(seeds, (keys // n, keys % n), vals * d[keys % n])
    return seeds


def _pull_host(g: csr.Graph, w: np.ndarray, x: np.ndarray) -> np.ndarray:
    out = np.zeros(g.n, dtype=np.float64)
    np.add.at(out, g.edge_dst, x[g.edge_src] * w)
    return out


def single_source_paper(idx, g: csr.Graph, u: int) -> np.ndarray:
    """Faithful Alg 6 on dense n-vectors (host, float64)."""
    sc, theta = idx.plan.sqrt_c, idx.plan.theta
    w = csr.normalized_pull_weights(g, sc).astype(np.float64)
    seeds = _seed_matrix(idx, u)
    out = np.zeros(idx.n, dtype=np.float64)
    for l in range(seeds.shape[0]):
        rho = seeds[l]
        if not rho.any():
            continue
        tau = (sc ** l) * theta
        for _ in range(l):
            rho = _pull_host(g, w, np.where(rho > tau, rho, 0.0))
        out += rho
    return out


def single_source_horner(idx, g: csr.Graph, u: int) -> np.ndarray:
    """Horner-stacked push (host, float64)."""
    w = csr.normalized_pull_weights(g, idx.plan.sqrt_c).astype(np.float64)
    seeds = _seed_matrix(idx, u)
    L = seeds.shape[0] - 1
    tau = prune_tau(idx.plan)
    acc = seeds[L].copy()
    for l in range(L - 1, -1, -1):
        acc = _pull_host(g, w, np.where(acc > tau, acc, 0.0)) + seeds[l]
    return acc


def horner_push(ku, xu, d, layout, tau: float, *, n: int,
                l_max: int) -> torch.Tensor:
    """Plain PyTorch Horner push: (B, W) packed rows -> (B, n) float32."""
    return hpk.horner_push(ku, xu, d, layout, tau, n=n, l_max=l_max,
                           steps=hpk.horner_steps_plain)


def batched_single_source(keys, vals, d, layout, us, tau: float, *,
                          n: int, l_max: int,
                          backend: str = "auto") -> torch.Tensor:
    """Horner push for a batch of sources: keys/vals (N, K) packed
    table, us (B,) int64 ids -> (B, n) float32 on the table's device.
    ``backend``: "auto" | "kernel" | "plain" (``kernels.horner_push``)."""
    steps = hpk.steps_for(hpk.resolve_push_backend(backend, keys.device))
    return hpk.horner_push(keys[us], vals[us], d, layout, tau, n=n,
                           l_max=l_max, steps=steps)
