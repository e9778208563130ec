"""Deterministic, step-keyed synthetic data (port of
``repro/data/pipeline.py``: ``TokenStream``, ``RecsysStream``,
``gnn_batch`` and ``host_slice``).

Every batch is a pure function of (seed, step), drawn with the same
NumPy calls in the same order as the reference, so both packages see
the same batches bit for bit. Arrays stay NumPy (ids int32); the model
moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.graph import csr


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Synthetic LM token stream (zipf-ish unigram over the vocab)."""
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (z % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class RecsysStream:
    n_fields: int
    vocab: int
    batch: int
    multi_hot_fields: int = 0
    bag_size: int = 8
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        ids = (rng.zipf(1.2, size=(self.batch, self.n_fields))
               % self.vocab).astype(np.int32)
        out = {"ids": ids,
               "labels": rng.integers(0, 2, self.batch).astype(np.int32)}
        if self.multi_hot_fields:
            out["mh_ids"] = (rng.zipf(
                1.2, size=(self.batch, self.multi_hot_fields,
                           self.bag_size)) % self.vocab).astype(np.int32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def gnn_batch(g: csr.Graph, d_feat: int, n_classes: int, seed: int = 0,
              sim_feat: Optional[np.ndarray] = None) -> dict:
    """Full-batch GNN training arrays for a graph (features synthetic
    but deterministic; labels from a planted partition so accuracy is
    learnable in examples), NumPy, bit for bit the reference's."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(g.n) * n_classes // max(g.n, 1)) % n_classes
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + rng.normal(
        scale=2.0, size=(g.n, d_feat)).astype(np.float32)
    batch = {
        "feats": feats,
        "edge_src": g.edge_src.astype(np.int32),
        "edge_dst": g.edge_dst.astype(np.int32),
        "edge_mask": np.ones(g.m, np.float32),
        "node_mask": np.ones(g.n, np.float32),
        "labels": labels.astype(np.int32),
    }
    if sim_feat is not None:
        batch["sim_feat"] = sim_feat.astype(np.float32)
    return batch


def host_slice(batch: dict, host_id: int = 0, n_hosts: int = 1) -> dict:
    """Per-host row slice for multi-host feeding (identity on 1 host)."""
    if n_hosts == 1:
        return batch
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        lo = rows * host_id // n_hosts
        hi = rows * (host_id + 1) // n_hosts
        out[k] = v[lo:hi]
    return out
