"""Top-k single-source SimRank: Horner push + a stable selection.

Port of ``repro/core/topk.py``. Ties go to the smaller node id, as in
the reference (``jax.lax.top_k``). ``torch.topk`` promises no order
among equal values, so the selection is a stable descending sort,
which keeps equal scores in ascending id order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.single_source import (batched_single_source,
                                            single_source_paper)
from repro_torch.graph import csr


def stable_topk(scores: torch.Tensor, k: int):
    """(B, n) scores -> (values (B, k), ids (B, k) int32), descending,
    equal scores in ascending id order."""
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


def batched_topk(keys, vals, d, layout, us, tau: float, *, n: int,
                 l_max: int, k: int, backend: str = "auto"):
    """Horner push + top-k for a batch of sources: (scores (B, k)
    float32, nodes (B, k) int32) on the table's device."""
    scores = batched_single_source(keys, vals, d, layout, us, tau, n=n,
                                   l_max=l_max, backend=backend)
    return stable_topk(scores, k)


def topk_device(idx, g: csr.Graph, us, k: int,
                backend: str | None = None, device=None):
    """One-shot batched top-k on ``device`` (``cuda`` unless
    ``device="cpu"``), k clamped to n: (scores (B, k) float32, nodes
    (B, k) int32) as NumPy. The working set is warm after the first call
    (``core/device_state.py``)."""
    from repro_torch.core import device_state
    k = min(int(k), idx.n)
    st = device_state.serving_arrays(idx, g, device)
    us = torch.as_tensor(np.asarray(us, np.int64), device=st.d.device)
    top_v, top_i = batched_topk(st.keys, st.vals, st.d, st.layout, us,
                                st.tau, n=idx.n, l_max=idx.plan.l_max, k=k,
                                backend=backend)
    return top_v.cpu().numpy(), top_i.cpu().numpy()


def topk_host(idx, g: csr.Graph, u: int, k: int,
              method=single_source_paper):
    """Reference: dense host scores + stable argsort (ties -> small id)."""
    scores = np.asarray(method(idx, g, u))
    k = min(int(k), len(scores))
    order = np.argsort(-scores, kind="stable")[:k]
    return scores[order], order.astype(np.int32)
