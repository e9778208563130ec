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

``GraphDelta`` / ``apply_edges`` mutate the edge set of a fixed node set
for incremental index maintenance (``core/update.py``).
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

    @property
    def out_deg(self) -> np.ndarray:
        return np.diff(self.out_ptr)

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.in_idx[self.in_ptr[v]:self.in_ptr[v + 1]]

    def out_neighbors(self, v: int) -> np.ndarray:
        return self.out_idx[self.out_ptr[v]:self.out_ptr[v + 1]]

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


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A batch of edge mutations against a fixed node set.

    Directed edges (src -> dst). The node count never changes under a
    delta: the hot-swap contract relies on every (n,)-shaped array
    keeping its shape; growing n is a full rebuild. Inserting an edge
    that already exists, or deleting one that does not, is a no-op (and
    does not mark its endpoint as touched).
    """
    add_src: np.ndarray  # (a,) int64
    add_dst: np.ndarray  # (a,) int64
    del_src: np.ndarray  # (d,) int64
    del_dst: np.ndarray  # (d,) int64

    @staticmethod
    def empty() -> "GraphDelta":
        z = np.zeros(0, np.int64)
        return GraphDelta(z, z, z, z)

    @staticmethod
    def inserts(src, dst) -> "GraphDelta":
        z = np.zeros(0, np.int64)
        return GraphDelta(np.asarray(src, np.int64),
                          np.asarray(dst, np.int64), z, z)

    @staticmethod
    def deletes(src, dst) -> "GraphDelta":
        z = np.zeros(0, np.int64)
        return GraphDelta(z, z, np.asarray(src, np.int64),
                          np.asarray(dst, np.int64))

    def __len__(self) -> int:
        return len(self.add_src) + len(self.del_src)


def _member(keys: np.ndarray, sorted_ref: np.ndarray) -> np.ndarray:
    """Which of ``keys`` occur in the sorted array ``sorted_ref``."""
    if len(keys) == 0 or len(sorted_ref) == 0:
        return np.zeros(len(keys), bool)
    pos = np.clip(np.searchsorted(sorted_ref, keys), 0, len(sorted_ref) - 1)
    return sorted_ref[pos] == keys


def apply_edges(g: Graph, delta: GraphDelta
                ) -> tuple[Graph, np.ndarray, np.ndarray]:
    """Apply a :class:`GraphDelta`, returning (new_graph, touched, tv).

    ``touched`` is the sorted array of nodes whose in-neighborhood
    actually changed: every SLING quantity (d_k, H(v) entries, pull
    weights) depends on the graph only through in-neighbor lists, so a
    genuine insert or delete of (u -> v) touches ``v`` only. ``tv``
    (aligned with ``touched``) is #changed in-edges / max(old deg, new
    deg, 1), clipped to 1: a bound on the total-variation distance
    between the old and new transition kernels at the node. Edges keep
    their multiplicity (a multigraph stays one); an insert and a delete
    of the same edge in one batch cancel; ids outside [0, n) raise.
    """
    n = g.n
    old = g.edge_src.astype(np.int64) * n + g.edge_dst.astype(np.int64)
    old_sorted = np.sort(old)
    # the key src*n + dst would alias an out-of-range pair onto a real
    # edge, so both sides of inserts and deletes are checked
    for side in (delta.add_src, delta.add_dst,
                 delta.del_src, delta.del_dst):
        side = np.asarray(side, np.int64)
        if len(side) and (side.min() < 0 or side.max() >= n):
            raise ValueError("delta references node ids outside [0, n)")
    add = (np.asarray(delta.add_src, np.int64) * n
           + np.asarray(delta.add_dst, np.int64))
    dele = (np.asarray(delta.del_src, np.int64) * n
            + np.asarray(delta.del_dst, np.int64))
    add = np.unique(add) if len(add) else add
    dele = np.unique(dele) if len(dele) else dele
    if len(add) and len(dele):
        both = np.intersect1d(add, dele)
        if len(both):
            add = np.setdiff1d(add, both)
            dele = np.setdiff1d(dele, both)
    eff_add = add[~_member(add, old_sorted)] if len(add) else add
    eff_del = dele[_member(dele, old_sorted)] if len(dele) else dele
    if len(eff_add) == 0 and len(eff_del) == 0:
        return g, np.zeros(0, np.int64), np.zeros(0, np.float64)

    keep = (~_member(old, np.sort(eff_del)) if len(eff_del)
            else np.ones(len(old), bool))
    new_keys = np.concatenate([old[keep], eff_add])
    g2 = from_edges(n, new_keys // n, new_keys % n, dedup=False)
    touched, n_changed = np.unique(np.concatenate([eff_add, eff_del]) % n,
                                   return_counts=True)
    deg_ref = np.maximum(np.maximum(g.in_deg[touched],
                                    g2.in_deg[touched]), 1)
    tv = np.minimum(n_changed / deg_ref, 1.0)
    return g2, touched, tv


def undirected(n: int, a: np.ndarray, b: np.ndarray) -> Graph:
    """Symmetrize: every undirected {a,b} becomes both (a->b) and (b->a)."""
    return from_edges(n, np.concatenate([a, b]), np.concatenate([b, a]))


def normalized_pull_weights(g: Graph, sqrt_c: float) -> np.ndarray:
    """Per-edge weight sqrt(c)/|I(dst)| of the pull operator Â (float32)."""
    deg = np.maximum(g.in_deg, 1).astype(np.float64)
    return (sqrt_c / deg[g.edge_dst]).astype(np.float32)
