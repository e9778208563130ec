"""Deterministic, step-keyed synthetic data (port of
``repro/data/pipeline.py``: ``RecsysStream`` and ``gnn_batch``; the
token stream comes with the LM stack).

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
