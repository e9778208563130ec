"""Deterministic, step-keyed synthetic data (port of
``repro/data/pipeline.py``; ``RecsysStream`` so far).

Every batch is a pure function of (seed, step), drawn with the same
NumPy calls in the same order as the reference, so both packages see
the same batches bit for bit. Arrays stay NumPy (ids int32); the model
moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


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
