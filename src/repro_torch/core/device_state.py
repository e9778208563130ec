"""Process-wide cache of the device-resident working set of the
one-shot query helpers (port of ``repro/core/device_state.py``).

``single_source_device`` and ``topk_device`` take host objects per
call (an index and a graph). The port's index already lives on its
device; what a call would otherwise rebuild and upload each time is the
``Â`` operator's CSR layout (:class:`~repro_torch.kernels.spmv_ell.
SpmmLayout`, the port's counterpart of the reference's Pallas blocked
layout) and the prune threshold. This module keeps them warm per
(index, graph) and invalidates them by a cheap fingerprint: the
index's ``epoch`` (which every ``update_index`` batch bumps) and the
identities of the arrays, so a rebound array is a new entry.

Entries are evicted by weakref finalizers when the index or the graph
dies, plus an LRU cap of 8 as a backstop against id reuse. Long-lived
serving should still prefer :class:`~repro_torch.serve.QueryEngine`,
which adds capacity-bucketed shapes across hot swaps.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import OrderedDict

import torch

from repro_torch.graph import csr

_MAX_ENTRIES = 8
_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


@dataclasses.dataclass(frozen=True)
class ServingArrays:
    """The single-source/top-k working set on the index's device: the
    packed index (the index's own tensors), Â's layout and tau."""
    keys: torch.Tensor   # (n, width) int32
    vals: torch.Tensor   # (n, width) float32
    d: torch.Tensor      # (n,) float32
    layout: object       # kernels.spmv_ell.SpmmLayout
    tau: float


def _fingerprint(idx, g: csr.Graph) -> tuple:
    return (idx.epoch, id(idx.plan), id(idx.hp.keys), id(idx.hp.vals),
            id(idx.d), idx.hp.width, id(g.edge_src), id(g.edge_dst), g.m)


def serving_arrays(idx, g: csr.Graph) -> ServingArrays:
    """The single-source/top-k working set, Â's layout built and
    uploaded to the index's device once per (index epoch, graph)."""
    from repro_torch.core.single_source import prune_tau
    from repro_torch.kernels.spmv_ell import SpmmLayout
    key, fp = (id(idx), id(g)), _fingerprint(idx, g)
    hit = _cache.get(key)
    if hit is not None and hit[0] == fp:
        _cache.move_to_end(key)
        return hit[1]
    value = ServingArrays(
        keys=idx.hp.keys, vals=idx.vals_f32(), d=idx.d,
        layout=SpmmLayout.pull(g, idx.plan.sqrt_c, idx.device),
        tau=prune_tau(idx.plan))
    _cache[key] = (fp, value)
    _cache.move_to_end(key)
    for owner in (idx, g):
        weakref.finalize(owner, _cache.pop, key, None)
    while len(_cache) > _MAX_ENTRIES:
        _cache.popitem(last=False)
    return value


def cache_clear() -> None:
    _cache.clear()


def cache_len() -> int:
    return len(_cache)
