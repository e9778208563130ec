"""Practical optimizations of paper Section 5, ported from
``repro/core/optimizations.py``. Host NumPy, as in the reference; the
index's tensors are read on the host and written back in place.

5.2 Space reduction: for nodes whose 2-hop in-neighborhood size
    eta(v) = |I(v)| + sum_{x in I(v)} |I(x)| is <= gamma/theta, drop the
    stored step-1 and step-2 HPs; the host path recomputes them exactly
    at query time with Algorithm 5 (``exact_step12``).

5.3 Accuracy enhancement: mark the 1/sqrt(eps) largest HPs
    h~^(l)(v, j) whose target j has |I(j)| <= 1/sqrt(eps); at query time
    the host path extends each marked entry one exact step into H*(v).
    All added mass is <= the true HP, so accuracy only improves.

Only ``SlingIndex.query_pair_host`` and the host single-source paths
(given the graph) read the results; ``QueryEngine`` refuses a reduced
index and ignores the marks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.graph import csr


def eta(g: csr.Graph) -> np.ndarray:
    """eta(v) = |I(v)| + sum_{x in I(v)} |I(x)| (paper Section 5.2)."""
    deg = g.in_deg.astype(np.int64)
    out = deg.copy()
    np.add.at(out, g.edge_dst, deg[g.edge_src])
    return out


def exact_step12(g: csr.Graph, v: int, sqrt_c: float):
    """Algorithm 5: exact step-1/2 HPs from v. Returns (keys, vals) with
    key = l*n + k, sorted ascending (int64, float64)."""
    n = g.n
    h1: dict[int, float] = {}
    h2: dict[int, float] = {}
    nbrs = g.in_neighbors(v)
    if len(nbrs) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    p1 = sqrt_c / len(nbrs)
    for x in nbrs:
        h1[int(x)] = h1.get(int(x), 0.0) + p1
    for x, px in list(h1.items()):
        nb2 = g.in_neighbors(x)
        if len(nb2) == 0:
            continue
        p2 = sqrt_c * px / len(nb2)
        for y in nb2:
            h2[int(y)] = h2.get(int(y), 0.0) + p2
    keys = ([np.int64(1) * n + k for k in h1] +
            [np.int64(2) * n + k for k in h2])
    vals = list(h1.values()) + list(h2.values())
    keys = np.asarray(keys, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.argsort(keys)
    return keys[order], vals[order]


def apply_space_reduction(idx, g: csr.Graph, gamma: float = 10.0) -> int:
    """Drop step-1/2 entries for nodes with eta(v) <= gamma/theta.

    Changes ``idx`` in place: repacks the reduced rows (keys, vals and
    counts, on the index's device) and sets ``idx.reduced``. Returns the
    bytes saved (4 B key + 4 B val a dropped entry)."""
    if idx.quant is not None:
        raise ValueError("cannot space-reduce a quantized index: "
                         "repacking writes fp32 into codes")
    if idx.read_only:
        raise ValueError("cannot space-reduce a read-only (mapped) "
                         "index; load it eagerly")
    n = idx.n
    lim = gamma / idx.plan.theta
    reduced = eta(g) <= lim
    keys = idx.hp.keys.cpu().numpy().copy()
    vals = idx.hp.vals.cpu().numpy().copy()
    counts = idx.hp.counts.cpu().numpy().copy()
    before = int(counts.sum())
    for v in np.flatnonzero(reduced):
        cnt = int(counts[v])
        if cnt == 0:
            continue
        steps = keys[v, :cnt] // n
        keep = (steps == 0) | (steps > 2)
        kk = keys[v, :cnt][keep]
        vv = vals[v, :cnt][keep]
        keys[v, :] = INT32_PAD_KEY
        vals[v, :] = 0.0
        keys[v, : len(kk)] = kk
        vals[v, : len(kk)] = vv
        counts[v] = len(kk)
    for t, a in ((idx.hp.keys, keys), (idx.hp.vals, vals),
                 (idx.hp.counts, counts)):
        t.copy_(torch.from_numpy(a))
    idx.reduced = reduced
    return (before - int(counts.sum())) * 8


def mark_for_enhancement(idx, g: csr.Graph) -> None:
    """Section 5.3 preprocessing: store the row offsets of the
    1/sqrt(eps) largest markable HPs per node in ``idx.marks``.

    Refuses a quantized index: the query-time extension reads the
    marked entries' float32 values."""
    if idx.quant is not None:
        raise ValueError("cannot mark a quantized index for "
                         "enhancement; mark the float32 index")
    n = idx.n
    budget = max(1, int(math.floor(1.0 / math.sqrt(idx.plan.eps))))
    deg = g.in_deg
    all_keys = idx.hp.keys.cpu().numpy()
    all_vals = idx.hp.vals.cpu().numpy()
    counts = idx.hp.counts.cpu().numpy()
    marks = np.full((n, budget), -1, dtype=np.int32)
    for v in range(n):
        cnt = int(counts[v])
        if cnt == 0:
            continue
        keys = all_keys[v, :cnt]
        vals = all_vals[v, :cnt]
        tgt = keys % n
        ok = deg[tgt] <= budget
        cand = np.flatnonzero(ok)
        if len(cand) == 0:
            continue
        # NumPy's default (unstable) sort, as the reference: ties keep
        # the reference's order
        top = cand[np.argsort(-vals[cand])][:budget]
        marks[v, : len(top)] = top.astype(np.int32)
    idx.marks = marks


def enhance_entries(idx, g: csr.Graph, v: int, keys: np.ndarray,
                    vals: np.ndarray):
    """Build H*(v) from H(v) on the fly (query-time part of 5.3)."""
    if idx.marks is None:
        return keys, vals
    n = idx.n
    cnt = int(idx.hp.counts[v])
    row_keys = idx.hp.keys[v, :cnt].cpu().numpy().astype(np.int64)
    row_vals = idx.vals_f32(v)[:cnt].cpu().numpy()
    key_set = set(int(k) for k in keys)
    extra: dict[int, float] = {}
    for off in idx.marks[v]:
        if off < 0 or off >= cnt:
            continue
        key = int(row_keys[off])
        l, j = key // n, key % n
        val = float(row_vals[off])
        nbrs = g.in_neighbors(j)
        if len(nbrs) == 0:
            continue
        p = idx.plan.sqrt_c * val / len(nbrs)
        for k in nbrs:
            nk = (l + 1) * n + int(k)
            if nk in key_set:
                continue  # already have a (better) stored estimate
            extra[nk] = extra.get(nk, 0.0) + p
    if not extra:
        return keys, vals
    ek = np.fromiter(extra.keys(), dtype=np.int64)
    ev = np.fromiter(extra.values(), dtype=np.float64)
    keys = np.concatenate([keys, ek])
    vals = np.concatenate([vals, ev])
    order = np.argsort(keys)
    return keys[order], vals[order]
