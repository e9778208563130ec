"""Hitting-probability index construction: Algorithm 2, dense blocked.

Port of the single-device dense build of ``repro/core/hp_index.py``.
A block of B target nodes is propagated as a dense (n, B) frontier
through the pull operator

    (Â x)(v) = sqrt(c) / |I(v)| * sum_{u in I(v)} x(u),

zeroing entries <= theta before each propagation (Alg 2's prune). Kept
entries at step l are the elements of H(.) with key l*n + k.

The pull is a fixed-order CSR reduction: ``graph.edge_dst`` is sorted,
so the messages x[in_idx] * w form one contiguous run per destination,
and ``torch.segment_reduce`` sums each run in edge order in one thread.
``index_add_`` on CUDA would add with atomics in an order that changes
from run to run, which can move entries within rounding of theta in or
out of H between two builds of the same graph; the fixed order cannot.

The kept entries are extracted on the device (``torch.nonzero`` of the
pruned frontier) and packed on the device; only the packed table and
nothing of the (steps, n, B) frontier stack reaches the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph import csr

INT32_PAD_KEY = 2**31 - 1


def capacity_bucket(x: int, quantum: int = 64,
                    headroom: float = 1.25) -> int:
    """Smallest multiple of ``quantum`` >= x * headroom (>= quantum)."""
    return max(quantum, int(-(-int(x * headroom) // quantum) * quantum))


@dataclasses.dataclass(frozen=True)
class PullGraph:
    """The pull operator Â in CSR over destinations, on one device."""
    n: int
    in_ptr: torch.Tensor   # (n+1,) int64 segment offsets
    in_idx: torch.Tensor   # (m,) int64 edge sources
    w: torch.Tensor        # (m,) float32 sqrt(c)/|I(dst)|

    @staticmethod
    def from_graph(g: csr.Graph, sqrt_c: float, device) -> "PullGraph":
        return PullGraph(
            n=g.n,
            in_ptr=torch.as_tensor(g.in_ptr, dtype=torch.int64,
                                   device=device),
            in_idx=torch.as_tensor(g.in_idx, dtype=torch.int64,
                                   device=device),
            w=torch.as_tensor(csr.normalized_pull_weights(g, sqrt_c),
                              device=device))


def pull(x: torch.Tensor, in_ptr: torch.Tensor, in_idx: torch.Tensor,
         w: torch.Tensor) -> torch.Tensor:
    """Â x for a node-major (n, B) float32 ``x``: per destination v the
    sum of w_e * x[src_e] over its in-edges, in edge order."""
    msgs = x[in_idx] * w[:, None]
    return torch.segment_reduce(msgs, "sum", offsets=in_ptr, axis=0,
                                unsafe=True, initial=0.0)


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


def _propagate_block_coo(h: torch.Tensor, pg: PullGraph, theta: float,
                         l_max: int, target_ids: torch.Tensor):
    """Run the pruned pull (Alg 2) for one seed block and collect the
    kept entries as COO triples (src node, key = l*n + target, value),
    on the device. Columns of ``h`` beyond ``target_ids`` are inert
    padding. Stops once no entry of the frontier exceeds theta."""
    n = pg.n
    srcs, keys, vals = [], [], []
    nb = len(target_ids)
    for l in range(l_max + 1):
        hp = torch.where(h > theta, h, 0.0)
        i_idx, b_idx = torch.nonzero(hp[:, :nb], as_tuple=True)
        srcs.append(i_idx.to(torch.int32))
        keys.append((l * n + target_ids[b_idx]).to(torch.int32))
        vals.append(hp[i_idx, b_idx])
        if l == l_max:
            break
        h = pull(hp, pg.in_ptr, pg.in_idx, pg.w)
        if not bool((h > theta).any()):
            break
    return torch.cat(srcs), torch.cat(keys), torch.cat(vals)


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
                   l_max: int, block: int = 256, device="cpu") -> HPTable:
    """Construct H(v) for all v by blocked dense propagation on
    ``device``: ``block`` target columns per (n, block) frontier."""
    n = g.n
    if (l_max + 1) * n >= INT32_PAD_KEY:
        raise ValueError("int32 key space exceeded: (l_max+1)*n >= 2^31-1")
    device = torch.device(device)
    pg = PullGraph.from_graph(g, sqrt_c, device)
    theta32 = float(np.float32(theta))   # the prune compares in float32
    parts = []
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        tid = torch.arange(b0, b1, device=device)
        h = torch.zeros((n, block), dtype=torch.float32, device=device)
        h[tid, tid - b0] = 1.0
        parts.append(_propagate_block_coo(h, pg, theta32, l_max, tid))
    src, key, val = (torch.cat([p[i] for p in parts]) for i in range(3))
    return _pack_coo(src, key, val, n, theta, sqrt_c, l_max)
