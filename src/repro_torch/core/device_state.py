"""Process-wide cache of the device-resident working set of the
one-shot query helpers (port of ``repro/core/device_state.py``).

``single_source_device``, ``topk_device`` and ``SlingIndex.
query_pairs`` take host objects per call (an index, and a graph for the
first two) and run on the device they are given
(``cuda`` unless ``device="cpu"``), wherever the index's storage lies:
a mapped index lives in host memory and still serves on the card. What
a call would otherwise rebuild and upload each time is the packed table
(dequantized on the device when quantized; no copy for a float32 index
already there), the ``Â`` operator's CSR layout (:class:`~repro_torch.
kernels.spmv_ell.SpmmLayout`, the port's counterpart of the
reference's Pallas blocked layout) and the prune threshold. This module
keeps them warm per (index, device) for the pair join
(:func:`index_arrays`) and per (index, graph, device) for the push
(:func:`serving_arrays`), and invalidates them by a cheap
fingerprint: the index's ``epoch`` (which every ``update_index``
batch bumps) and the identities of the arrays, so a rebound array is a
new entry. The push's working set refuses a space-reduced index: its
packed rows lack the entries only the host path re-materializes.

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

from repro_torch.device import resolve_device
from repro_torch.graph import csr

_MAX_ENTRIES = 8
_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


@dataclasses.dataclass(frozen=True)
class IndexArrays:
    """The packed index on one device (the pair join's working set)."""
    keys: torch.Tensor   # (n, width) int32
    vals: torch.Tensor   # (n, width) float32
    d: torch.Tensor      # (n,) float32


@dataclasses.dataclass(frozen=True)
class ServingArrays(IndexArrays):
    """The single-source/top-k working set on one device: the packed
    index (float32), Â's layout and tau."""
    layout: object       # kernels.spmv_ell.SpmmLayout
    tau: float


def _index_fingerprint(idx) -> tuple:
    return (idx.epoch, id(idx.plan), id(idx.hp.keys), id(idx.hp.vals),
            id(idx.d), idx.hp.width)


def _get(key: tuple, fingerprint: tuple, build, owners):
    """The cached value under ``key`` while its fingerprint holds, else
    ``build()`` cached anew (evicted when an owner dies, LRU-capped)."""
    hit = _cache.get(key)
    if hit is not None and hit[0] == fingerprint:
        _cache.move_to_end(key)
        return hit[1]
    value = build()
    _cache[key] = (fingerprint, value)
    _cache.move_to_end(key)
    for owner in owners:
        weakref.finalize(owner, _cache.pop, key, None)
    while len(_cache) > _MAX_ENTRIES:
        _cache.popitem(last=False)
    return value


def _upload(idx, dev) -> dict:
    """keys, float32 vals (dequantized on ``dev``) and d on ``dev``; no
    copy of a float32 index already there."""
    return dict(keys=idx.hp.keys.to(dev), vals=idx.vals_f32(device=dev),
                d=idx.d.to(dev))


def index_arrays(idx, device=None) -> IndexArrays:
    """The packed index (keys, float32 vals, d) on ``device`` (``cuda``
    unless ``device="cpu"``), uploaded once per index epoch."""
    dev = resolve_device(device)
    return _get(("index", id(idx), str(dev)), _index_fingerprint(idx),
                lambda: IndexArrays(**_upload(idx, dev)), (idx,))


def serving_arrays(idx, g: csr.Graph, device=None) -> ServingArrays:
    """The single-source/top-k working set on ``device`` (``cuda``
    unless ``device="cpu"``), uploaded and Â's layout built once per
    (index epoch, graph, device): one entry of its own, apart from
    :func:`index_arrays`'."""
    from repro_torch.core.single_source import prune_tau
    from repro_torch.kernels.spmv_ell import SpmmLayout
    idx.refuse_reduced("serving_arrays")
    dev = resolve_device(device)
    fp = _index_fingerprint(idx) + (id(g.edge_src), id(g.edge_dst), g.m)
    return _get(("serving", id(idx), id(g), str(dev)), fp,
                lambda: ServingArrays(
                    **_upload(idx, dev),
                    layout=SpmmLayout.pull(g, idx.plan.sqrt_c, dev),
                    tau=prune_tau(idx.plan)), (idx, g))


def cache_clear() -> None:
    _cache.clear()


def cache_len() -> int:
    return len(_cache)
