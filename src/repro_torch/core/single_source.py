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
    the chosen backend: the Hopper push kernel, one launch, on ``cuda``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph import csr
from repro_torch.kernels import horner_push as hpk


def prune_tau(plan) -> float:
    """The Horner prune threshold tau = (sqrt c)^l_max * theta."""
    return float(plan.theta * plan.sqrt_c ** plan.l_max)


def _seed_matrix(idx, u: int, g: csr.Graph) -> np.ndarray:
    """(L+1, n) float64: seeds[l, k] = h~^(l)(u,k) * d_k over H(u) as
    ``_host_entries`` gives it (dequantized, step-1/2 entries of a
    reduced row re-materialized, enhanced); duplicate keys add up."""
    n = idx.n
    keys, vals = idx._host_entries(u, g)
    d = idx.d.cpu().numpy()
    seeds = np.zeros((idx.plan.l_max + 1, n), dtype=np.float64)
    np.add.at(seeds, (keys // n, keys % n),
              vals * d[keys % n].astype(np.float64))
    return seeds


def _pull_host(g: csr.Graph, w: np.ndarray, x: np.ndarray) -> np.ndarray:
    out = np.zeros(g.n, dtype=np.float64)
    np.add.at(out, g.edge_dst, x[g.edge_src] * w)
    return out


def single_source_paper(idx, g: csr.Graph, u: int) -> np.ndarray:
    """Faithful Alg 6 on dense n-vectors (host, float64)."""
    sc, theta = idx.plan.sqrt_c, idx.plan.theta
    w = csr.normalized_pull_weights(g, sc).astype(np.float64)
    seeds = _seed_matrix(idx, u, g)
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
    seeds = _seed_matrix(idx, u, g)
    L = seeds.shape[0] - 1
    tau = prune_tau(idx.plan)
    acc = seeds[L].copy()
    for l in range(L - 1, -1, -1):
        acc = _pull_host(g, w, np.where(acc > tau, acc, 0.0)) + seeds[l]
    return acc


def horner_push(ku, xu, d, layout, tau: float, *, n: int,
                l_max: int) -> torch.Tensor:
    """Plain PyTorch Horner push: (B, W) packed rows -> (B, n) float32."""
    return hpk.horner_push(ku, xu, d, layout, tau, n=n, l_max=l_max)


def batched_single_source(keys, vals, d, layout, us, tau: float, *,
                          n: int, l_max: int,
                          backend: str = "auto") -> torch.Tensor:
    """Horner push for a batch of sources: keys/vals (N, K) packed
    table, us (B,) int32 or int64 ids -> (B, n) float32 on the table's
    device. ``backend``: "auto" | "kernel" | "plain"
    (``kernels.horner_push``); the kernel reads the rows through ``us``
    itself, in one launch."""
    if n != layout.n:
        raise ValueError(f"n={n} but the layout has n={layout.n}")
    push = hpk.push_for(hpk.resolve_push_backend(backend, keys.device))
    return push(keys, vals, d, us, layout, tau, l_max=l_max)


def single_source_device(idx, g: csr.Graph, us,
                         backend: str | None = None,
                         device=None) -> np.ndarray:
    """One-shot batched path on ``device`` (``cuda`` unless
    ``device="cpu"``, wherever the index's storage lies): (B,) ids ->
    (B, n) float32 NumPy. The working set is warm after the first call
    (``core/device_state.py``), so repeated calls measure the push, not
    the upload. ``backend``: "auto"/None | "kernel" | "plain"."""
    from repro_torch.core import device_state
    st = device_state.serving_arrays(idx, g, device)
    us = torch.as_tensor(np.asarray(us, np.int64), device=st.d.device)
    return batched_single_source(
        st.keys, st.vals, st.d, st.layout, us, st.tau, n=idx.n,
        l_max=idx.plan.l_max, backend=backend).cpu().numpy()
