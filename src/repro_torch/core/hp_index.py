"""Hitting-probability index construction and repair: Algorithm 2,
dense blocked and sparse.

Port of the single-device dense and sparse builds, the row repair and
the mass scans of ``repro/core/hp_index.py``. A block of B target nodes is
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
(steps, n, B) frontier stack reaches the host. A ``_CooSink`` collects
each block's triples, in memory or in spill files (``spill_dir``).

The dense frontier costs O(n * B) per block whatever its sparsity,
which stops it near 10^5 nodes; the sparse build
(:func:`_sparse_targets_coo`) keeps the frontier as (node, column,
value) triples on the device and scales to 10^6 nodes
(``build.build_index_scale``).
"""
from __future__ import annotations

import dataclasses
import os

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


def shard_layout(n: int, n_shards: int) -> tuple[int, int]:
    """(n_pad, n_loc): the node count padded so ``n_shards`` equal slabs
    of ``n_loc`` rows tile it exactly (shard s owns the global ids
    [s*n_loc, (s+1)*n_loc); ids >= n are padding)."""
    if not (1 <= n_shards <= n):
        raise ValueError(f"need 1 <= n_shards <= n, got {n_shards}/{n}")
    n_loc = -(-n // n_shards)
    return n_loc * n_shards, n_loc


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


def pad_packed_rows(hp: HPTable, n_pad: int, width_cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shard-sliceable packed layout: (n_pad, width_cap) keys/vals on the
    table's device. Row i < n is H(i) right-padded with the PAD sentinel
    (every join and push ignores it); rows >= n are all PAD, so a slab
    of the result is a self-contained packed table for its nodes."""
    if width_cap < hp.width or n_pad < hp.n:
        raise ValueError(f"caps below table size: width {width_cap} < "
                         f"{hp.width} or rows {n_pad} < {hp.n}")
    dev = hp.keys.device
    keys = torch.full((n_pad, width_cap), INT32_PAD_KEY, dtype=torch.int32,
                      device=dev)
    vals = torch.zeros((n_pad, width_cap), dtype=torch.float32, device=dev)
    keys[:hp.n, :hp.width] = hp.keys
    vals[:hp.n, :hp.width] = hp.vals
    return keys, vals


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _CooSink:
    """Collects the COO triples of a build block by block, in memory or
    in spill files (out-of-core assembly, paper Section 5.4).

    With ``spill_dir`` every non-empty block is written to
    ``<spill_dir>/<tag>_<b0>.npz`` as host arrays and ``collect`` reads
    the files back in the order they were added, so spilled and
    in-memory assembly give the same concatenation. In memory, the
    triples are kept as given (device tensors stay on their device).
    """

    def __init__(self, spill_dir: str | None, tag: str = "hp_block"):
        self.spill_dir = spill_dir
        self.tag = tag
        self._acc: list[tuple] = []
        self._files: list[str] = []

    def add(self, b0: int, src, key, val) -> None:
        if len(src) == 0:
            return
        if self.spill_dir is None:
            self._acc.append((src, key, val))
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, f"{self.tag}_{b0}.npz")
        np.savez(path, src=_host(src), key=_host(key), val=_host(val))
        self._files.append(path)

    def collect(self, device=None):
        """(src int32, key int32, val float32) tensors of every block in
        order, on ``device`` (default: where they lie; spill files are
        read into host memory)."""
        parts = self._acc
        if self.spill_dir is not None:
            parts = []
            for path in self._files:
                with np.load(path) as z:
                    parts.append(tuple(torch.from_numpy(z[k])
                                       for k in ("src", "key", "val")))
        if not parts:
            parts = [(torch.zeros(0, dtype=torch.int32),
                      torch.zeros(0, dtype=torch.int32),
                      torch.zeros(0, dtype=torch.float32))]
        return tuple(torch.cat([torch.as_tensor(p[i]).to(device)
                                for p in parts]) for i in range(3))


def _pack_coo(src, key, val, n: int, theta: float, sqrt_c: float,
              l_max: int, width: int | None = None) -> HPTable:
    """COO triples -> fixed-width packed HPTable (rows sorted by key,
    PAD sentinel), on the triples' device. The width is the reference's
    rule, ``max(width or 0, widest row, 1)``."""
    dev = src.device
    order = torch.argsort(src.long() * (1 << 31) + key.long())
    src, key, val = src[order].long(), key[order], val[order]
    counts = torch.bincount(src, minlength=n)
    width = max(width or 0, int(counts.max()) if len(src) else 0, 1)
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
                   l_max: int, block: int = 256, width: int | None = None,
                   spill_dir: str | None = None, progress: bool = False, *,
                   device=None) -> HPTable:
    """Construct H(v) for all v by blocked dense propagation on
    ``device`` (``cuda`` unless ``device="cpu"``): ``block`` target
    columns per (n, block) frontier. ``width`` is the least packed
    width (wider rows widen the table); ``spill_dir`` writes each
    block's triples to a spill file (:class:`_CooSink`) instead of
    holding them; ``progress`` prints every eighth block. The
    positional order is the reference's (whose ``fused`` switch, an XLA
    compile control, the port has no use for)."""
    n = g.n
    _check_key_space(n, l_max)
    device = resolve_device(device)
    lay = SpmmLayout.pull(g, sqrt_c, device)
    theta32 = float(np.float32(theta))   # the prune compares in float32
    sink = _CooSink(spill_dir)
    for b0 in range(0, n, block):
        sink.add(b0, *_seed_block_coo(lay, theta32, l_max, b0,
                                      min(b0 + block, n), block))
        if progress and (b0 // block) % 8 == 0:
            print(f"  hp block {b0}/{n}")
    src, key, val = sink.collect(device)
    return _pack_coo(src, key, val, n, theta, sqrt_c, l_max, width=width)


def _seed_block_coo(lay: SpmmLayout, theta32: float, l_max: int, b0: int,
                    b1: int, block: int):
    """Alg 2 for the contiguous targets [b0, b1) in an (n, block) frontier
    on the layout's device: the block of the dense build, whichever
    device or shard runs it."""
    dev = lay.device
    tid = torch.arange(b0, b1, device=dev)
    h = torch.zeros((lay.n, block), dtype=torch.float32, device=dev)
    h[tid, tid - b0] = 1.0
    return _propagate_block_coo(h, lay, theta32, l_max, tid)


def shard_build_hp(g: csr.Graph, theta: float, sqrt_c: float,
                   l_max: int, mesh, axis: str = "data", block: int = 256,
                   width: int | None = None, spill_dir: str | None = None,
                   progress: bool = False) -> HPTable:
    """Mesh-parallel :func:`build_hp_table` (paper Section 5.4): the
    targets go in superblocks of S * block columns, S =
    ``mesh.shape[axis]``, split by column (``launch/sharding.
    sling_build_specs``), so shard s propagates, on its own device with
    the graph replicated there, the very (n, block) block the
    single-device build would, through the same ``spmm`` steps. Columns
    are independent and each output is summed in an order set by its
    row alone, so the table equals ``build_hp_table(g, theta, sqrt_c,
    l_max, block=block)``'s on the first shard's device bit for bit;
    the triples are gathered and packed there. ``spill_dir`` spills a
    superblock's triples, so out-of-core assembly composes with
    sharding. The shards run in order from this thread."""
    from repro_torch.launch.sharding import sling_build_specs
    n = g.n
    _check_key_space(n, l_max)
    devices = mesh.axis_devices(sling_build_specs(axis)["seeds"][0])
    S = len(devices)
    home = devices[0]
    layouts = {dev: SpmmLayout.pull(g, sqrt_c, dev) for dev in devices}
    theta32 = float(np.float32(theta))
    sink = _CooSink(spill_dir, tag="hp_shard_block")
    for b0 in range(0, n, S * block):
        parts = []
        for s, dev in enumerate(devices):
            c0 = b0 + s * block
            if c0 >= n:
                break
            parts.append([t.to(home, non_blocking=True) for t in
                          _seed_block_coo(layouts[dev], theta32, l_max, c0,
                                          min(c0 + block, n), block)])
        sink.add(b0, *(torch.cat(ts) for ts in zip(*parts)))
        if progress:
            print(f"  hp superblock {b0}/{n} ({S}-way)")
    src, key, val = sink.collect(home)
    return _pack_coo(src, key, val, n, theta, sqrt_c, l_max, width=width)


def repair_hp_rows(g: csr.Graph, hp: HPTable, rows, targets,
                   block: int = 256, progress: bool = False) -> dict:
    """Row-repair mode of Alg 2 on the table's device: re-run the
    blocked pruned pull seeded only at ``targets`` over ``g`` and splice
    the entries into the packed rows ``rows`` of ``hp`` in place;
    ``progress`` prints every eighth target block.

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
        if progress and (b0 // block) % 8 == 0:
            print(f"  repair block {b0}/{len(targets)}")
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


# ----------------------------------------------------------------------
# sparse-frontier build (million-node scale, DESIGN.md section 13)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OutGraph:
    """What the sparse build pushes over, on one device: the out-CSR and
    the pull weight sqrt(c) / max(|I(v)|, 1) of every destination
    (float64, computed on the host as the reference does)."""
    n: int
    out_ptr: torch.Tensor   # (n+1,) int64
    out_idx: torch.Tensor   # (m,) int64
    inv_in: torch.Tensor    # (n,) float64

    @staticmethod
    def from_graph(g: csr.Graph, sqrt_c: float, device) -> "OutGraph":
        inv_in = sqrt_c / np.maximum(g.in_deg, 1).astype(np.float64)
        return OutGraph(
            n=g.n,
            out_ptr=torch.as_tensor(g.out_ptr.astype(np.int64),
                                    device=device),
            out_idx=torch.as_tensor(g.out_idx.astype(np.int64),
                                    device=device),
            inv_in=torch.as_tensor(inv_in, device=device))

    @property
    def device(self) -> torch.device:
        return self.out_ptr.device


def _segment_sum(x: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """float64 sum of each segment ``x[starts[i] : starts[i] + lens[i]]``
    (segments tile ``x`` in order), by a pairwise tree over the position
    inside the segment: at stride s = 1, 2, 4, ... the element at
    position r, r a multiple of 2s, adds the one at r + s if that lies in
    the segment. The adds are plain IEEE float64 adds in an order that
    depends only on the segment's own length, so a segment sums to the
    same bits whatever else ``x`` holds, on the CPU and on CUDA alike
    (``index_add_`` and ``scatter_add_`` use atomics on CUDA, whose order
    is not fixed)."""
    T = x.numel()
    seg = torch.repeat_interleave(
        torch.arange(len(lens), device=x.device), lens, output_size=T)
    rank = torch.arange(T, device=x.device) - starts[seg]
    room = lens[seg] - rank          # elements from r to the segment's end
    s = 1
    while s < max_len:
        take = ((rank & (2 * s - 1)) == 0) & (room > s)
        nxt = torch.nn.functional.pad(x[s:], (0, s))
        x = torch.where(take, x + nxt, x)
        s *= 2
    return x[starts]


def _sparse_targets_coo(og: OutGraph, targets, theta: float, l_max: int):
    """Alg 2 for the seed columns ``targets`` with the frontier kept
    sparse, on ``og``'s device: (node, column, value) triples instead of
    a dense (n, B) slab, whose O(n * B) footprint stops the dense build
    at ~10^5 nodes.

    Each step prunes the frontier in float32 with a strict ``> theta``,
    records it (key = l*n + target), and pushes it one step: a ragged
    gather of the kept nodes' out-edges, a stable sort on
    ``dst * B + column``, and a float64 :func:`_segment_sum` of each
    group. A column's groups hold its own contributions in an order set
    by its own frontier (sorted by node, then out-edge), and the sum's
    order depends only on the group, so a target's triples are the same
    bits however the targets are batched -- which makes the prsim and
    sling schedules emit the same entries. Against the reference
    (``np.add.reduceat``, another summation order) values agree to
    float64 rounding, and an entry within a float32 ulp of theta may be
    kept on one side only. Returns device tensors (src int32, key int32,
    value float32)."""
    dev = og.device
    targets = torch.as_tensor(np.asarray(targets, np.int64), device=dev)
    B = len(targets)
    srcs = [torch.zeros(0, dtype=torch.int32, device=dev)]
    keys = [torch.zeros(0, dtype=torch.int32, device=dev)]
    vals = [torch.zeros(0, dtype=torch.float32, device=dev)]
    theta32 = float(np.float32(theta))
    node = targets.clone()
    col = torch.arange(B, device=dev)
    val = torch.ones(B, dtype=torch.float64, device=dev)
    for l in range(l_max + 1 if B else 0):
        v32 = val.float()
        keep = torch.nonzero(v32 > theta32).squeeze(1)
        if keep.numel() == 0:
            break
        node, col, v32 = node[keep], col[keep], v32[keep]
        srcs.append(node.int())
        keys.append((l * og.n + targets[col]).int())
        vals.append(v32)
        if l == l_max:
            break
        # push the pruned frontier one step: a ragged gather of each
        # node's out-edges, then a sorted segment sum on (dst, column)
        starts = og.out_ptr[node]
        lens = og.out_ptr[node + 1] - starts
        total = int(lens.sum())
        if total == 0:
            break
        rep = torch.repeat_interleave(torch.arange(len(node), device=dev),
                                      lens, output_size=total)
        flat = (torch.arange(total, device=dev)
                + (starts - (torch.cumsum(lens, 0) - lens))[rep])
        dst = og.out_idx[flat]
        contrib = v32.double()[rep] * og.inv_in[dst]
        group = dst * B + col[rep]
        order = torch.argsort(group, stable=True)
        group, contrib = group[order], contrib[order]
        head = torch.ones(total, dtype=torch.bool, device=dev)
        head[1:] = group[1:] != group[:-1]
        g_starts = torch.nonzero(head).squeeze(1)
        g_lens = torch.diff(g_starts, append=torch.tensor([total],
                                                          device=dev))
        val = _segment_sum(contrib, g_starts, g_lens, int(g_lens.max()))
        heads = group[g_starts]
        node, col = heads // B, heads % B
    return torch.cat(srcs), torch.cat(keys), torch.cat(vals)


def _sparse_block_coo(og: OutGraph, b0: int, b1: int, theta: float,
                      l_max: int):
    """The SLING sparse build's seed schedule: the contiguous targets
    [b0, b1)."""
    return _sparse_targets_coo(og, np.arange(b0, b1, dtype=np.int64),
                               theta, l_max)


def sparse_hp_coo(g: csr.Graph, theta: float, sqrt_c: float, l_max: int,
                  block: int, sink: _CooSink, progress: bool = False,
                  device=None) -> None:
    """Drive :func:`_sparse_block_coo` over every seed block on
    ``device`` (``cuda`` unless ``device="cpu"``), handing each block's
    triples to ``sink`` as host arrays: the front half of the in-memory
    sparse build and of the streaming v3 scale path
    (``build.build_index_scale``)."""
    n = g.n
    _check_key_space(n, l_max)
    og = OutGraph.from_graph(g, sqrt_c, resolve_device(device))
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        sink.add(b0, *(_host(t) for t in
                       _sparse_block_coo(og, b0, b1, theta, l_max)))
        if progress and (b0 // block) % 8 == 0:
            print(f"  sparse hp block {b0}/{n}")


def build_hp_table_sparse(g: csr.Graph, theta: float, sqrt_c: float,
                          l_max: int, block: int = 2048,
                          width: int | None = None,
                          spill_dir: str | None = None,
                          progress: bool = False,
                          device=None) -> HPTable:
    """Sparse-frontier twin of :func:`build_hp_table`, packed on
    ``device``: its entries match the dense build's except at the theta
    prune boundary (:func:`_sparse_targets_coo`), and its footprint is
    O(live entries), not O(n * block)."""
    dev = resolve_device(device)
    sink = _CooSink(spill_dir, tag="hp_sparse")
    sparse_hp_coo(g, theta, sqrt_c, l_max, block, sink, progress=progress,
                  device=dev)
    src, key, val = sink.collect(dev)
    return _pack_coo(src, key, val, g.n, theta, sqrt_c, l_max, width=width)
