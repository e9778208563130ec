"""Embedding lookup and EmbeddingBag as torch ops (port of
``repro/models/embeddings.py``).

  * ``lookup``           -- a single-valued field: ``index_select``;
  * ``embedding_bag``    -- a ragged multi-hot field flattened to (ids,
    bag_ids) pairs, reduced per bag: ``index_add_`` for sum and mean,
    ``scatter_reduce`` for max;
  * ``field_lookup_all`` -- one id per field against the stacked
    per-field tables, as one gather over the flattened tables.

An empty bag gives what the reference gives: 0 for sum and mean, -inf
for max (the identity of ``jax.ops.segment_max``).
"""
from __future__ import annotations

import torch


def lookup(table: torch.Tensor, ids) -> torch.Tensor:
    """table (V, D), ids (...,) -> (..., D)."""
    ids = torch.as_tensor(ids, device=table.device).long()
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[-1])


def embedding_bag(table: torch.Tensor, ids, bag_ids, n_bags: int,
                  mode: str = "sum", weights=None) -> torch.Tensor:
    """Gather rows, then reduce them into ``n_bags`` bags.

    ids      (M,) row indices (flattened multi-hot)
    bag_ids  (M,) destination bag per id (sorted not required)
    weights  optional (M,) per-sample weights, applied in every mode as
             the reference does
    """
    dev = table.device
    ids = torch.as_tensor(ids, device=dev).long()
    bag_ids = torch.as_tensor(bag_ids, device=dev).long()
    rows = table.index_select(0, ids)                       # (M, D)
    if weights is not None:
        rows = rows * torch.as_tensor(weights, device=dev)[:, None]
    D = table.shape[-1]
    if mode in ("sum", "mean"):
        s = torch.zeros((n_bags, D), dtype=rows.dtype, device=dev)
        s.index_add_(0, bag_ids, rows)
        if mode == "sum":
            return s
        c = torch.zeros(n_bags, dtype=torch.float32, device=dev)
        c.index_add_(0, bag_ids, torch.ones_like(bag_ids, dtype=torch.float32))
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        out = torch.full((n_bags, D), float("-inf"), dtype=rows.dtype,
                         device=dev)
        return out.scatter_reduce_(0, bag_ids[:, None].expand(-1, D), rows,
                                   "amax", include_self=True)
    raise ValueError(mode)


def field_lookup_all(tables: torch.Tensor, ids) -> torch.Tensor:
    """ids (B, n_fields) against per-field stacked tables
    (n_fields, V, D) -> (B, n_fields, D)."""
    F, V, D = tables.shape
    ids = torch.as_tensor(ids, device=tables.device).long()
    B = ids.shape[0]
    rows = ids + torch.arange(F, device=tables.device)[None, :] * V
    return tables.reshape(F * V, D).index_select(0, rows.reshape(-1)) \
        .reshape(B, F, D)
