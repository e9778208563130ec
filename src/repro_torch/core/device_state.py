"""Process-wide cache of the device-resident working set of the
one-shot query helpers (port of ``repro/core/device_state.py``).

``single_source_device`` and ``topk_device`` take host objects per
call (an index and a graph) and run on the device they are given
(``cuda`` unless ``device="cpu"``), wherever the index's storage lies:
a mapped index lives in host memory and still serves on the card. What
a call would otherwise rebuild and upload each time is the packed table
(dequantized on the device when quantized; no copy for a float32 index
already there), the ``Â`` operator's CSR layout (:class:`~repro_torch.
kernels.spmv_ell.SpmmLayout`, the port's counterpart of the
reference's Pallas blocked layout) and the prune threshold. This module
keeps them warm per (index, graph, device) and invalidates them by a
cheap fingerprint: the index's ``epoch`` (which every ``update_index``
batch bumps) and the identities of the arrays, so a rebound array is a
new entry. A space-reduced index is refused: its packed rows lack the
entries only the host path re-materializes.

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
class ServingArrays:
    """The single-source/top-k working set on one device: the packed
    index (float32), Â's layout and tau."""
    keys: torch.Tensor   # (n, width) int32
    vals: torch.Tensor   # (n, width) float32
    d: torch.Tensor      # (n,) float32
    layout: object       # kernels.spmv_ell.SpmmLayout
    tau: float


def _fingerprint(idx, g: csr.Graph) -> tuple:
    return (idx.epoch, id(idx.plan), id(idx.hp.keys), id(idx.hp.vals),
            id(idx.d), idx.hp.width, id(g.edge_src), id(g.edge_dst), g.m)


def serving_arrays(idx, g: csr.Graph, device=None) -> ServingArrays:
    """The single-source/top-k working set on ``device`` (``cuda``
    unless ``device="cpu"``), uploaded and Â's layout built once per
    (index epoch, graph, device)."""
    from repro_torch.core.single_source import prune_tau
    from repro_torch.kernels.spmv_ell import SpmmLayout
    idx.refuse_reduced("serving_arrays")
    dev = resolve_device(device)
    key, fp = (id(idx), id(g), str(dev)), _fingerprint(idx, g)
    hit = _cache.get(key)
    if hit is not None and hit[0] == fp:
        _cache.move_to_end(key)
        return hit[1]
    value = ServingArrays(
        keys=idx.hp.keys.to(dev), vals=idx.vals_f32(device=dev),
        d=idx.d.to(dev), layout=SpmmLayout.pull(g, idx.plan.sqrt_c, dev),
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
