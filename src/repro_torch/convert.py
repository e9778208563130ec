"""Carry graphs and built indexes across from plain arrays.

A graph or index built elsewhere (the JAX reference, a saved run) is
handed over as NumPy arrays and a plan dict, so both packages can
answer the same queries on the same state with no RNG in between:

    g2 = graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    idx2 = index_from_arrays(dataclasses.asdict(idx.plan), idx.d,
                             idx.hp.keys, idx.vals_f32(), idx.hp.counts,
                             device="cpu")
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hp_index import HPTable
from repro_torch.core.index import SlingIndex
from repro_torch.core.theory import SlingPlan
from repro_torch.device import resolve_device
from repro_torch.graph import csr


def graph_from_arrays(n: int, src, dst) -> csr.Graph:
    """Graph from a directed edge list; parallel edges are kept, so a
    multigraph keeps its multiplicities."""
    return csr.from_edges(int(n), np.asarray(src), np.asarray(dst),
                          dedup=False)


def index_from_arrays(plan: dict, d, keys, vals, counts,
                      builder: str = "sling", uncertified_d: bool = False,
                      device=None) -> SlingIndex:
    """SlingIndex from a plan dict (``dataclasses.asdict`` of a plan),
    d (n,), packed keys/vals (n, width) and counts (n,), on ``device``
    (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    p = SlingPlan(**plan)
    keys = np.asarray(keys, np.int32)
    vals = np.asarray(vals, np.float32)
    if keys.ndim != 2 or vals.shape != keys.shape:
        raise ValueError("keys/vals must be one (n, width) shape")
    n, width = keys.shape
    hp = HPTable(n=n, width=width,
                 keys=torch.as_tensor(keys, device=dev),
                 vals=torch.as_tensor(vals, device=dev),
                 counts=torch.as_tensor(np.asarray(counts, np.int32),
                                        device=dev),
                 theta=p.theta, sqrt_c=p.sqrt_c, l_max=p.l_max)
    return SlingIndex(plan=p,
                      d=torch.as_tensor(np.asarray(d, np.float32),
                                        device=dev),
                      hp=hp, builder=builder, uncertified_d=uncertified_d)
