"""Monte Carlo baseline (Fogaras & Racz, paper Section 3.2).

Port of ``repro/baselines/montecarlo.py``. The index holds n_w
*truncated reverse random walks* per node: every step continues with
probability 1 (SLING's sqrt(c)-walks stop), so the estimator c^tau must
be truncated at step t, biasing it by <= c^{t+1} (Eq. 4). A pair (u, v)
is estimated by (1/n_w) sum_l c^{tau_l}, tau_l the first step at which
the l-th walks from u and v coincide.

Paper parameterization: t > log_c(eps/2) and n_w >= 14/(3 eps^2)
(log(2/delta) + 2 log n) give eps error for ALL pairs w.p. >= 1 - delta.
The index stores n * n_w * (t+1) node ids -- the O(n log(n/delta) /
eps^2) space cost that motivates SLING.

The build draws on the host with the reference's NumPy generator, the
same calls in the same order, so ``walks`` equals the reference's bit
for bit; the (n, n_w, t+1) int32 walks then live on the device
(``cuda`` unless ``device="cpu"``), where the queries run: a pair is one
comparison of two (n_w, t+1) blocks, a single source one comparison of
``walks[u]`` against every node's block.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import csr


@dataclasses.dataclass
class MCIndex:
    c: float
    t: int
    n_w: int
    walks: torch.Tensor  # (n, n_w, t+1) int32, -1 once the walk is stuck

    def nbytes(self) -> int:
        return self.walks.numel() * self.walks.element_size()


def params_for(eps: float, delta: float, n: int, c: float):
    t = max(1, int(math.ceil(math.log(eps / 2.0) / math.log(c))))
    n_w = int(math.ceil(14.0 / (3.0 * eps * eps)
                        * (math.log(2.0 / delta) + 2.0 * math.log(max(n, 2)))))
    return t, n_w


def build(g: csr.Graph, eps: float = 0.025, delta: float | None = None,
          c: float = 0.6, seed: int = 0, n_w_override: int | None = None,
          *, device=None) -> MCIndex:
    """Draw the walks on the host (the reference's draws), then put them
    on ``device``."""
    dev = resolve_device(device)
    delta = delta if delta is not None else 1.0 / g.n
    t, n_w = params_for(eps, delta, g.n, c)
    if n_w_override is not None:
        n_w = n_w_override
    rng = np.random.default_rng(seed)
    n = g.n
    walks = np.full((n, n_w, t + 1), -1, dtype=np.int32)
    pos = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, n_w))
    walks[:, :, 0] = pos
    deg = g.in_deg.astype(np.int64)
    in_ptr = g.in_ptr.astype(np.int64)
    stuck = deg[pos] == 0
    for step in range(1, t + 1):
        d = deg[pos]
        r = rng.integers(0, np.maximum(d, 1))
        nxt = g.in_idx[np.minimum(in_ptr[pos] + r, g.m - 1)]
        pos = np.where(stuck, pos, nxt).astype(np.int32)
        walks[:, :, step] = np.where(stuck, -1, pos)
        stuck = stuck | (deg[pos] == 0)
    return MCIndex(c=c, t=t, n_w=n_w, walks=torch.from_numpy(walks).to(dev))


def _estimate(mc: MCIndex, same: torch.Tensor) -> torch.Tensor:
    """The estimator over the last two axes of ``same`` (..., n_w, t+1),
    True where coupled walks coincide: the mean over the walks of
    c^(first meeting step), 0 where they never meet (float64)."""
    met = same.any(dim=-1)
    # argmax takes no bool on CUDA; among ties it returns the first index
    first = same.to(torch.uint8).argmax(dim=-1).to(torch.float64)
    return torch.where(met, torch.pow(mc.c, first), 0.0).mean(dim=-1)


def query_pair(mc: MCIndex, u: int, v: int) -> float:
    if u == v:
        return 1.0
    wu, wv = mc.walks[u], mc.walks[v]       # (n_w, t+1)
    return float(_estimate(mc, (wu == wv) & (wu >= 0)))


def query_single_source(mc: MCIndex, u: int) -> np.ndarray:
    """Every node's estimate against u at once (the reference loops over
    v), with s(u, u) = 1."""
    w = mc.walks
    out = _estimate(mc, (w == w[u]) & (w >= 0))
    out[u] = 1.0
    return out.cpu().numpy()
