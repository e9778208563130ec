"""Neighbor sampler for minibatch GNN training (GraphSAGE-style; port of
``repro/graph/sampler.py``).

Real fanout sampling over the in-CSR: for each seed node draw up to
fanout[0] in-neighbors, then fanout[1] of theirs, etc. Emits a padded
fixed-shape subgraph (the minibatch_lg shape cell's contract): node
table, edge (src, dst) pairs in *local* subgraph ids, masks. The draws
are the reference's ``rng.choice`` calls in its order, so equal NumPy
generators give equal arrays in both packages.

SimRank-weighted sampling (DESIGN.md section 5): neighbors are sampled
proportionally to their SimRank similarity to the node being expanded.
Pass ``knn=`` a materialized :class:`~repro_torch.join.KnnGraph` (built
once by the bulk join, :mod:`repro_torch.join`) -- the per-node weights
are O(k) host lookups into the artifact's CSR rows. The legacy
``sim_index=`` path (a live SlingIndex) re-runs a full host
single-source push (``single_source_horner``) per visited node, as the
reference does, and remains only as a reference; prefer ``knn``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph import csr


@dataclasses.dataclass
class SampledSubgraph:
    node_ids: np.ndarray    # (N_pad,) global ids, -1 padding
    edge_src: np.ndarray    # (M_pad,) local ids
    edge_dst: np.ndarray    # (M_pad,)
    edge_mask: np.ndarray   # (M_pad,) float32
    node_mask: np.ndarray   # (N_pad,)
    seed_index: np.ndarray  # (B,) local ids of the seed nodes


_SIM_FLOOR = 1e-9   # keeps unscored neighbors reachable (p > 0)


def _knn_weights(knn, v: int, nbrs: np.ndarray) -> np.ndarray:
    """Sampling weights for ``nbrs`` of ``v`` from a materialized
    KnnGraph row: the floor plus the artifact score where stored, the
    floor elsewhere (a neighbor outside v's top-k scored below every
    stored entry; the floor keeps it samplable without a device
    dispatch). The reference adds each score to the floor in float64
    through a dict; one vectorized add of the same values gives the same
    bits."""
    w = np.full(len(nbrs), _SIM_FLOOR)
    if knn.has(v):
        ids, scores = knn.neighbors(v)
        order = np.argsort(ids, kind="stable")
        ids, scores = ids[order], scores[order]
        pos = np.minimum(np.searchsorted(ids, nbrs), max(len(ids) - 1, 0))
        hit = (ids[pos] == nbrs) if len(ids) else np.zeros(len(nbrs), bool)
        w[hit] += scores[pos[hit]].astype(np.float64)
    return w


def sample_subgraph(g: csr.Graph, seeds: np.ndarray, fanout, rng,
                    n_pad: int, m_pad: int,
                    sim_index=None, knn=None) -> SampledSubgraph:
    """The padded subgraph of ``seeds`` and their sampled in-neighbors
    (``fanout`` per hop), drawn from the NumPy generator ``rng``."""
    local: dict[int, int] = {}
    node_ids: list[int] = []

    def intern(v: int) -> int:
        if v not in local:
            local[v] = len(node_ids)
            node_ids.append(v)
        return local[v]

    for s in seeds:
        intern(int(s))
    frontier = [int(s) for s in seeds]
    es, ed = [], []
    for f in fanout:
        nxt = []
        for v in frontier:
            nbrs = g.in_neighbors(v)
            if len(nbrs) == 0:
                continue
            k = min(f, len(nbrs))
            if knn is not None:
                w = _knn_weights(knn, v, np.asarray(nbrs))
                picks = rng.choice(nbrs, size=k, replace=False,
                                   p=w / w.sum())
            elif sim_index is not None:
                from repro_torch.core.single_source import \
                    single_source_horner
                w = single_source_horner(sim_index, g, v)[nbrs] + _SIM_FLOOR
                picks = rng.choice(nbrs, size=k, replace=False,
                                   p=w / w.sum())
            else:
                picks = rng.choice(nbrs, size=k, replace=False)
            dv = local[v]
            for u in picks.tolist():
                es.append(intern(u))
                ed.append(dv)
                nxt.append(u)
        frontier = nxt

    N, M = len(node_ids), len(es)
    if N > n_pad or M > m_pad:
        raise ValueError(f"sampled {N} nodes and {M} edges; the pads are "
                         f"n_pad={n_pad}, m_pad={m_pad}")
    out = SampledSubgraph(
        node_ids=np.full(n_pad, -1, np.int32),
        edge_src=np.zeros(m_pad, np.int32),
        edge_dst=np.zeros(m_pad, np.int32),
        edge_mask=np.zeros(m_pad, np.float32),
        node_mask=np.zeros(n_pad, np.float32),
        seed_index=np.array([local[int(s)] for s in seeds], np.int32),
    )
    out.node_ids[:N] = node_ids
    out.edge_src[:M] = es
    out.edge_dst[:M] = ed
    out.edge_mask[:M] = 1.0
    out.node_mask[:N] = 1.0
    return out
