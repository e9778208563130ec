"""The SLING index object and single-pair queries (Alg 3).

Port of ``repro/core/index.py`` (fp32 indexes, no on-disk artifact
yet; ``stale`` and ``epoch`` carry the incremental-maintenance state of
``core/update.py``). Index = { d~_k for all k } + packed HP table
{ H(v) for all v }, both as tensors on one device.

Single-pair query: s~(u,v) = sum over matching (l,k) keys of
h~(u;l,k) * d_k * h~(v;l,k).

  * ``query_pair_host``    -- scalar merge join on the host (float64);
  * ``_pair_query_batch``  -- batched searchsorted join as torch ops
    (the reference's vmapped join, one row of the batch per query).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.hp_index import INT32_PAD_KEY, HPTable


@dataclasses.dataclass
class SlingIndex:
    plan: theory.SlingPlan
    d: torch.Tensor        # (n,) float32 correction factors
    hp: HPTable
    builder: str = "sling"
    # True when d carries no eps_d certificate; QueryEngine refuses it
    # unless EngineConfig.allow_uncertified
    uncertified_d: bool = False
    # wall seconds of the build phases ({"d": .., "hp": ..}), if built
    build_seconds: dict = dataclasses.field(default_factory=dict)
    stale: float = 0.0     # staleness charged against plan.eps_stale
    epoch: int = 0         # bumped by every applied update batch

    @property
    def n(self) -> int:
        return self.hp.n

    @property
    def device(self) -> torch.device:
        return self.d.device

    def vals_f32(self) -> torch.Tensor:
        """HP vals as float32 (the port stores fp32 indexes only)."""
        return self.hp.vals

    def nbytes(self) -> int:
        return self.hp.nbytes() + self.d.numel() * self.d.element_size()

    def query_pair_host(self, u: int, v: int) -> float:
        """Alg 3 as a scalar merge join over H(u) and H(v), float64."""
        def row(x):
            c = int(self.hp.counts[x])
            return (self.hp.keys[x, :c].cpu().numpy().astype(np.int64),
                    self.hp.vals[x, :c].cpu().numpy().astype(np.float64))
        ku, vu = row(u)
        kv, vv = row(v)
        d = self.d.cpu().numpy()
        n = self.n
        i = j = 0
        s = 0.0
        while i < len(ku) and j < len(kv):
            a, b = ku[i], kv[j]
            if a == b:
                s += vu[i] * float(d[a % n]) * vv[j]
                i += 1
                j += 1
            elif a < b:
                i += 1
            else:
                j += 1
        return float(s)

    def query_pairs(self, us, vs) -> np.ndarray:
        dev = self.device
        return _pair_query_batch(
            self.hp.keys, self.hp.vals, self.d,
            torch.as_tensor(us, dtype=torch.int64, device=dev),
            torch.as_tensor(vs, dtype=torch.int64, device=dev),
            self.n).cpu().numpy()


def _pair_query_batch(keys, vals, d, us, vs, n: int) -> torch.Tensor:
    """Sorted-key join for a batch of pairs: keys (N, K) int32 ascending
    with PAD; us/vs (B,) int64. Returns (B,) float32. On duplicate keys
    in row v it takes the first match, as the reference does."""
    K = keys.shape[1]
    ku, xu = keys[us], vals[us]
    kv, xv = keys[vs], vals[vs]
    idx = torch.searchsorted(kv, ku).clamp_(max=K - 1)
    match = (kv.gather(1, idx) == ku) & (ku != INT32_PAD_KEY)
    dk = d[(ku.long() % n).clamp_(0, n - 1)]
    prod = xu * xv.gather(1, idx) * dk
    return torch.where(match, prod, 0.0).sum(dim=1)
