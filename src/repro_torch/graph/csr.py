"""Compressed sparse graph representation (host, NumPy).

Port of ``repro/graph/csr.py``: the same arrays from the same edge
list. Directed, unweighted graph with n nodes and m edges, stored in
both orientations:

  - in-CSR : ``in_ptr`` (n+1,), ``in_idx`` (m,) -- I(v) = in_idx[in_ptr[v]:in_ptr[v+1]]
  - out-CSR: ``out_ptr`` (n+1,), ``out_idx`` (m,)
  - the pull-oriented edge list grouped by destination: ``edge_dst``
    is sorted and ``edge_src`` equals ``in_idx``, so ``in_ptr`` is the
    CSR over destinations that the Horner-push kernel walks.

Nodes with no in-neighbors are absorbing for reverse walks; d_k = 1
there (two walks from k stop at once and never meet after step 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    n: int
    m: int
    in_ptr: np.ndarray   # (n+1,) int64
    in_idx: np.ndarray   # (m,) int32, concatenated in-neighbor lists
    out_ptr: np.ndarray  # (n+1,) int64
    out_idx: np.ndarray  # (m,) int32
    edge_dst: np.ndarray  # (m,) int32, sorted (grouped by destination)
    edge_src: np.ndarray  # (m,) int32

    @property
    def in_deg(self) -> np.ndarray:
        return np.diff(self.in_ptr)

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.in_idx[self.in_ptr[v]:self.in_ptr[v + 1]]

    def validate(self) -> None:
        if self.in_ptr.shape != (self.n + 1,) or \
                self.out_ptr.shape != (self.n + 1,):
            raise ValueError("CSR pointer arrays must have n+1 entries")
        if self.in_idx.shape != (self.m,) or self.out_idx.shape != (self.m,):
            raise ValueError("CSR index arrays must have m entries")
        if self.in_ptr[0] != 0 or self.in_ptr[-1] != self.m or \
                self.out_ptr[0] != 0 or self.out_ptr[-1] != self.m:
            raise ValueError("CSR pointers must span [0, m]")
        if self.m and (min(self.in_idx.min(), self.out_idx.min()) < 0 or
                       max(self.in_idx.max(), self.out_idx.max()) >= self.n):
            raise ValueError("edge endpoint outside [0, n)")


def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
               dedup: bool = True) -> Graph:
    """Build a :class:`Graph` from a directed edge list (src -> dst)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if dedup and len(src):
        key = src * n + dst
        key, keep = np.unique(key, return_index=True)
        src, dst = src[keep], dst[keep]
    m = len(src)

    order_in = np.argsort(dst, kind="stable")
    in_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(in_ptr, dst + 1, 1)
    in_ptr = np.cumsum(in_ptr)

    order_out = np.argsort(src, kind="stable")
    out_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(out_ptr, src + 1, 1)
    out_ptr = np.cumsum(out_ptr)

    g = Graph(n=n, m=m,
              in_ptr=in_ptr,
              in_idx=src[order_in].astype(np.int32),
              out_ptr=out_ptr,
              out_idx=dst[order_out].astype(np.int32),
              edge_dst=dst[order_in].astype(np.int32),
              edge_src=src[order_in].astype(np.int32))
    g.validate()
    return g


def undirected(n: int, a: np.ndarray, b: np.ndarray) -> Graph:
    """Symmetrize: every undirected {a,b} becomes both (a->b) and (b->a)."""
    return from_edges(n, np.concatenate([a, b]), np.concatenate([b, a]))


def normalized_pull_weights(g: Graph, sqrt_c: float) -> np.ndarray:
    """Per-edge weight sqrt(c)/|I(dst)| of the pull operator Â (float32)."""
    deg = np.maximum(g.in_deg, 1).astype(np.float64)
    return (sqrt_c / deg[g.edge_dst]).astype(np.float32)
