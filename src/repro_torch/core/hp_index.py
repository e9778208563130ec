"""Hitting-probability index construction and repair: Algorithm 2,
dense blocked.

Port of the single-device dense build, the row repair and the mass
scans of ``repro/core/hp_index.py``. A block of B target nodes is
propagated as a dense (n, B) frontier through the pull operator

    (Â x)(v) = sqrt(c) / |I(v)| * sum_{u in I(v)} x(u),

zeroing entries <= theta before each propagation (Alg 2's prune). Kept
entries at step l are the elements of H(.) with key l*n + k.

Every application of Â goes through ``kernels.spmv_ell.spmm``: the
Hopper kernel for CUDA tensors, ``spmm_plain`` (a fixed-order
``segment_reduce`` over the CSR) for CPU tensors. Each step hands it the
raw frontier with the prune threshold and the frontier's mask of live
32-column segments, and takes back the next frontier and its mask, so
the kernel reads only segments that hold an entry above theta, and the
build's stop test reads the mask. Both versions sum each output
in an order that depends only on its row, never with atomics, so a
column propagated inside any block of columns gives the same values --
which is what lets ``repair_hp_rows`` reproduce a fresh build's
entries, and keeps entries within rounding of theta from moving in or
out of H between two builds of one graph.

The kept entries are extracted on the device (``torch.nonzero`` of the
pruned frontier) and packed and merged on the device; nothing of the
(steps, n, B) frontier stack reaches the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import csr
from repro_torch.kernels.spmv_ell import SpmmLayout, segment_live, spmm

INT32_PAD_KEY = 2**31 - 1


def capacity_bucket(x: int, quantum: int = 64,
                    headroom: float = 1.25) -> int:
    """Smallest multiple of ``quantum`` >= x * headroom (>= quantum)."""
    return max(quantum, int(-(-int(x * headroom) // quantum) * quantum))


@dataclasses.dataclass
class HPTable:
    """Fixed-width packed H sets for the whole graph, on one device.

    keys[i]: int32 sorted ascending, key = l * n + k, padded with
    INT32_PAD_KEY; vals[i] aligned; counts[i] = live entries.
    """
    n: int
    width: int
    keys: torch.Tensor    # (n, width) int32
    vals: torch.Tensor    # (n, width) float32
    counts: torch.Tensor  # (n,) int32
    theta: float
    sqrt_c: float
    l_max: int

    def entries(self, v: int):
        """Decode H(v) -> list of (l, k, value)."""
        c = int(self.counts[v])
        ks = self.keys[v, :c].tolist()
        xs = self.vals[v, :c].tolist()
        return [(k // self.n, k % self.n, x) for k, x in zip(ks, xs)]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.keys, self.vals, self.counts))


def _check_key_space(n: int, l_max: int) -> None:
    if (l_max + 1) * n >= INT32_PAD_KEY:
        raise ValueError("int32 key space exceeded: (l_max+1)*n >= 2^31-1")


def _propagate_block_coo(h: torch.Tensor, layout: SpmmLayout, theta: float,
                         l_max: int, target_ids: torch.Tensor,
                         row_mask: torch.Tensor | None = None):
    """Run the pruned pull (Alg 2) for one seed block and collect the
    kept entries as COO triples (src node, key = l*n + target, value),
    on the device. Columns of ``h`` beyond ``target_ids`` are inert
    padding; ``row_mask`` (bool (n,), row repair) keeps only the
    entries of those source rows. Stops once no entry of the frontier
    exceeds theta (later steps would keep nothing)."""
    n = layout.n
    srcs, keys, vals = [], [], []
    nb = len(target_ids)
    live = segment_live(h, theta)
    for l in range(l_max + 1):
        kept = torch.where(h[:, :nb] > theta, h[:, :nb], 0.0)
        if row_mask is not None:
            kept = torch.where(row_mask[:, None], kept, 0.0)
        i_idx, b_idx = torch.nonzero(kept, as_tuple=True)
        srcs.append(i_idx.to(torch.int32))
        keys.append((l * n + target_ids[b_idx]).to(torch.int32))
        vals.append(kept[i_idx, b_idx])
        if l == l_max:
            break
        # Â prune(h) and the live mask of the result: the kernel reads
        # only the segments that ``live`` marks
        live_out = torch.empty_like(live)
        h = spmm(h, layout, tau=theta, live=live, live_out=live_out)
        live = live_out
        if not bool(live.any()):      # no entry of h exceeds theta
            break
    return torch.cat(srcs), torch.cat(keys), torch.cat(vals)


def _one_hot_block(n: int, sub, block: int, device, min_pad: int = 16,
                   weights=None) -> torch.Tensor:
    """(n, B) float32 seed columns for the node ids ``sub`` (value
    ``weights``, default 1), B padded to a power-of-two bucket (at least
    ``min_pad``, at most ``block`` unless ``sub`` is longer), so the
    frontier shapes stay a fixed set; padding columns are all-zero and
    generate no entries and no mass."""
    k = len(sub)
    B = max(min_pad, int(2 ** np.ceil(np.log2(max(k, 1)))))
    B = min(B, block) if k <= block else k
    B = max(B, k)
    vals = (torch.ones(k, dtype=torch.float32, device=device)
            if weights is None else
            torch.as_tensor(np.asarray(weights, np.float32), device=device))
    h = torch.zeros((n, B), dtype=torch.float32, device=device)
    h[torch.as_tensor(np.asarray(sub, np.int64), device=device),
      torch.arange(k, device=device)] = vals
    return h


def propagation_mass(g: csr.Graph, seeds, sqrt_c: float, theta_r: float,
                     l_max: int, transpose: bool = False, block: int = 256,
                     weights=None, device=None):
    """Pruned propagation mass from weighted one-hot ``seeds`` (weights
    default to 1), per seed column, on ``device`` (``cuda`` unless
    ``device="cpu"``).

    transpose=False (pull, :meth:`SpmmLayout.pull`): column t holds
      sum_l h~^(l)(v, t), the discounted mass with which v hits t.
    transpose=True (push, :meth:`SpmmLayout.push`): column t holds the
      walk-distribution mass from t.

    Every block runs all l_max + 1 steps, as the reference's scan does:
    ``acc += hp`` and ``skip += h - hp`` are taken before each step's
    prune at theta_r discards the sub-threshold mass. Returns host
    float64 arrays (colmax, total, skipped), each (n,): the largest
    single-seed mass at v, the surviving mass summed over seeds, and
    the pruned mass summed over steps and seeds.
    """
    dev = resolve_device(device)
    n = g.n
    lay = (SpmmLayout.push if transpose else SpmmLayout.pull)(g, sqrt_c, dev)
    theta32 = float(np.float32(theta_r))
    colmax = torch.zeros(n, dtype=torch.float64, device=dev)
    total = torch.zeros(n, dtype=torch.float64, device=dev)
    skipped = torch.zeros(n, dtype=torch.float64, device=dev)
    seeds = np.asarray(seeds, np.int64)
    for b0 in range(0, len(seeds), block):
        sub = seeds[b0:b0 + block]
        wsub = None if weights is None else weights[b0:b0 + block]
        h = _one_hot_block(n, sub, block, dev, weights=wsub)
        live = segment_live(h, theta32)
        acc = torch.zeros_like(h)
        skip = torch.zeros_like(h)
        for l in range(l_max + 1):
            hp = torch.where(h > theta32, h, 0.0)
            acc += hp
            skip += h - hp
            if l < l_max:       # the last step's propagation is unused
                live_out = torch.empty_like(live)
                h = spmm(h, lay, tau=theta32, live=live, live_out=live_out)
                live = live_out
        colmax = torch.maximum(colmax, acc.max(dim=1).values.double())
        total += acc.double().sum(dim=1)
        skipped += skip.double().sum(dim=1)
    return tuple(t.cpu().numpy() for t in (colmax, total, skipped))


def _pack_coo(src, key, val, n: int, theta: float, sqrt_c: float,
              l_max: int) -> HPTable:
    """COO triples -> fixed-width packed HPTable (rows sorted by key,
    PAD sentinel), on the triples' device."""
    dev = src.device
    order = torch.argsort(src.long() * (1 << 31) + key.long())
    src, key, val = src[order].long(), key[order], val[order]
    counts = torch.bincount(src, minlength=n)
    width = max(int(counts.max()) if len(src) else 0, 1)
    keys = torch.full((n, width), INT32_PAD_KEY, dtype=torch.int32,
                      device=dev)
    vals = torch.zeros((n, width), dtype=torch.float32, device=dev)
    row_start = torch.cumsum(counts, 0) - counts
    cols = torch.arange(len(src), device=dev) - row_start[src]
    keys[src, cols] = key
    vals[src, cols] = val
    return HPTable(n=n, width=width, keys=keys, vals=vals,
                   counts=counts.to(torch.int32), theta=theta,
                   sqrt_c=sqrt_c, l_max=l_max)


def build_hp_table(g: csr.Graph, theta: float, sqrt_c: float,
                   l_max: int, block: int = 256, device=None) -> HPTable:
    """Construct H(v) for all v by blocked dense propagation on
    ``device`` (``cuda`` unless ``device="cpu"``): ``block`` target
    columns per (n, block) frontier."""
    n = g.n
    _check_key_space(n, l_max)
    device = resolve_device(device)
    lay = SpmmLayout.pull(g, sqrt_c, device)
    theta32 = float(np.float32(theta))   # the prune compares in float32
    parts = []
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        tid = torch.arange(b0, b1, device=device)
        h = torch.zeros((n, block), dtype=torch.float32, device=device)
        h[tid, tid - b0] = 1.0
        parts.append(_propagate_block_coo(h, lay, theta32, l_max, tid))
    src, key, val = (torch.cat([p[i] for p in parts]) for i in range(3))
    return _pack_coo(src, key, val, n, theta, sqrt_c, l_max)


def repair_hp_rows(g: csr.Graph, hp: HPTable, rows, targets,
                   block: int = 256) -> dict:
    """Row-repair mode of Alg 2 on the table's device: re-run the
    blocked pruned pull seeded only at ``targets`` over ``g`` and splice
    the entries into the packed rows ``rows`` of ``hp`` in place.

    Alg-2 columns are independent, so the propagation seeded at a target
    k yields exactly the h~(v; l, k) a from-scratch build on ``g`` gives.
    In every repaired row, old entries whose target is in ``targets``
    are replaced by the fresh ones (absent = pruned = deleted); old
    entries of other targets are kept. Rows outside ``rows`` are
    untouched. The merge is one device pass: mark old entries with
    ``torch.isin`` on the sorted targets, concatenate the kept ones with
    the new ones, sort once on row * 2^31 + key, scatter the rows back.
    A merged row wider than the table re-pads the whole table at the
    wider width (PAD sentinel preserved). Returns repair stats."""
    n = g.n
    _check_key_space(n, hp.l_max)
    rows = np.asarray(rows, np.int64)
    targets = np.asarray(targets, np.int64)
    if len(rows) == 0 or len(targets) == 0:
        return {"rows": 0, "targets": int(len(targets)), "entries": 0,
                "width_grew": False}
    dev = hp.keys.device
    lay = SpmmLayout.pull(g, hp.sqrt_c, dev)
    theta32 = float(np.float32(hp.theta))
    rows_t = torch.as_tensor(rows, device=dev)
    row_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    row_mask[rows_t] = True
    parts = []
    for b0 in range(0, len(targets), block):
        sub = targets[b0:b0 + block]
        h = _one_hot_block(n, sub, block, dev)
        parts.append(_propagate_block_coo(
            h, lay, theta32, hp.l_max, torch.as_tensor(sub, device=dev),
            row_mask))
    new_src, new_key, new_val = (torch.cat([p[i] for p in parts])
                                 for i in range(3))

    # old entries of the repaired rows whose target is not re-seeded
    k_old, v_old = hp.keys[rows_t], hp.vals[rows_t]
    live = (torch.arange(hp.width, device=dev)[None, :]
            < hp.counts[rows_t].long()[:, None])
    tgt_sorted = torch.sort(torch.as_tensor(targets, device=dev)).values
    keep = live & ~torch.isin(k_old.long() % n, tgt_sorted)
    r_idx, c_idx = torch.nonzero(keep, as_tuple=True)
    src = torch.cat([rows_t[r_idx], new_src.long()])
    key = torch.cat([k_old[r_idx, c_idx], new_key])
    val = torch.cat([v_old[r_idx, c_idx], new_val])
    order = torch.argsort(src * (1 << 31) + key.long())
    src, key, val = src[order], key[order], val[order]
    row_counts = torch.bincount(src, minlength=n)
    counts = hp.counts.clone()
    counts[rows_t] = row_counts[rows_t].to(torch.int32)

    w_needed = max(int(counts.max()), 1)
    width_grew = w_needed > hp.width
    if width_grew:
        keys2 = torch.full((n, w_needed), INT32_PAD_KEY, dtype=torch.int32,
                           device=dev)
        vals2 = torch.zeros((n, w_needed), dtype=torch.float32, device=dev)
        keys2[:, :hp.width] = hp.keys
        vals2[:, :hp.width] = hp.vals
        hp.keys, hp.vals, hp.width = keys2, vals2, w_needed
    hp.keys[rows_t] = INT32_PAD_KEY
    hp.vals[rows_t] = 0.0
    cols = (torch.arange(len(src), device=dev)
            - (torch.cumsum(row_counts, 0) - row_counts)[src])
    hp.keys[src, cols] = key
    hp.vals[src, cols] = val
    hp.counts = counts
    return {"rows": int(len(rows)), "targets": int(len(targets)),
            "entries": int(len(new_src)), "width_grew": width_grew}


def exact_hp_vectors(g: csr.Graph, targets, sqrt_c: float,
                     l_max: int) -> np.ndarray:
    """Un-thresholded HP vectors h^(l)(., k) for test oracles (host).

    Returns (l_max+1, n, len(targets)) float64.
    """
    n = g.n
    targets = np.asarray(targets, np.int64)
    w = csr.normalized_pull_weights(g, sqrt_c).astype(np.float64)
    h = np.zeros((n, len(targets)))
    h[targets, np.arange(len(targets))] = 1.0
    out = [h.copy()]
    for _ in range(l_max):
        nxt = np.zeros_like(h)
        np.add.at(nxt, g.edge_dst, h[g.edge_src] * w[:, None])
        out.append(nxt.copy())
        h = nxt
    return np.stack(out)
