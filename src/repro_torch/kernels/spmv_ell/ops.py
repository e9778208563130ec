"""The CSR layout of the Â operator that the ``spmm`` and Horner-step
kernels walk, and the reference's kernel-level entries over a graph.

Port of ``repro/kernels/spmv_ell/ops.py``: :func:`spmm` and
:func:`spmm_reference` take (x, graph, per-edge weights) as the
reference's do; its Pallas tiling arguments (``bn``, ``eb``,
``interpret``) and ``block_align`` have no counterpart here. The TPU
layout groups edges into destination blocks padded for a one-hot
matmul; the port's layout is a plain CSR over the operator's *outputs*
(:class:`SpmmLayout`): ``in_ptr``/``in_idx``/``w`` list, per output row,
the input rows it sums and their weights, with the rows split by
in-degree so that a heavy row (above ``HEAVY_DEGREE``) gets a block of
its own in the kernels.

  * :meth:`SpmmLayout.pull` -- Â over the in-CSR:
    out[v] = sum_{u in I(v)} sqrt(c)/|I(v)| * x[u] (Alg 2's pull);
  * :meth:`SpmmLayout.push` -- the transposed operator over the
    out-CSR: out[u] = sum_{u -> v} sqrt(c)/|I(v)| * x[v], each out-edge
    carrying the weight of its destination (the reference's
    ``transpose=True`` mass scan).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import csr
from repro_torch.kernels.cost import is_fake
from repro_torch.kernels.spmv_ell.spmv_ell import spmm as spmm_kernel
from repro_torch.kernels.spmv_ell.spmv_ell import spmm_plain

# in-degree above which the kernels give a row a block of its own
HEAVY_DEGREE = 32
# in-degree bounds of the Horner push's tiers of rows: low (one thread
# a column group), mid and wide (16 and 32 threads a row); above the
# last, big (a block of its own)
PUSH_TIERS = (8, 32, 128)


@dataclasses.dataclass(frozen=True)
class SpmmLayout:
    """An operator in CSR over its output rows on one device (int32 for
    the kernels), and the row ids split by in-degree."""
    n: int
    in_ptr: torch.Tensor   # (n+1,) int32
    in_idx: torch.Tensor   # (m,) int32 input rows, grouped by output row
    w: torch.Tensor        # (m,) float32 per-edge weights
    heavy: torch.Tensor    # int32 ids with in-degree > HEAVY_DEGREE
    light: torch.Tensor    # int32 ids of the other rows
    # the Horner push's view: every row id once, by tier of in-degree
    # (PUSH_TIERS: low, mid, wide, big; ascending ids within a tier), and
    # the four tiers' sizes; derived from in_ptr when the layout is made
    push_order: torch.Tensor = dataclasses.field(init=False, repr=False)
    push_tiers: tuple = dataclasses.field(init=False)

    def __post_init__(self):
        """Check the arrays once, here, so that a kernel wrapper called
        every step checks only its own arguments against ``n`` and the
        layout's device."""
        ts = (self.in_ptr, self.in_idx, self.w, self.heavy, self.light)
        if self.in_ptr.shape != (self.n + 1,) or \
                self.w.shape != self.in_idx.shape or \
                self.heavy.numel() + self.light.numel() != self.n:
            raise ValueError(f"SpmmLayout shapes do not fit n={self.n}")
        if self.w.dtype != torch.float32 or any(
                t.dtype != torch.int32 for t in ts if t is not self.w):
            raise TypeError("SpmmLayout takes float32 w and int32 indices")
        if len({t.device for t in ts}) != 1 or \
                not all(t.is_contiguous() for t in ts):
            raise ValueError("SpmmLayout arrays must be contiguous on one "
                             "device")
        deg = self.in_ptr[1:] - self.in_ptr[:-1]
        tier = sum((deg > bound).int() for bound in PUSH_TIERS)
        order = torch.sort(tier, stable=True).indices
        object.__setattr__(self, "push_order", order.int().contiguous())
        if is_fake(self.in_ptr):
            # a fake layout (the dry run's) holds no degrees: every row
            # counted in the lowest tier, which the cost does not read
            counts = [self.n] + [0] * len(PUSH_TIERS)
        else:
            counts = torch.bincount(
                tier, minlength=len(PUSH_TIERS) + 1).tolist()
        object.__setattr__(self, "push_tiers", tuple(counts))

    @property
    def device(self) -> torch.device:
        return self.in_ptr.device

    @staticmethod
    def from_edges(src, dst, w, n: int, device) -> "SpmmLayout":
        """Any edge list (input row src -> output row dst, weight w):
        edges are grouped by output row with a stable sort, so each
        row's edges keep their input order."""
        dst = np.asarray(dst, np.int64)
        order = np.argsort(dst, kind="stable")
        deg = np.bincount(dst, minlength=n)
        ptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=ptr[1:])

        def ids(mask):
            return torch.as_tensor(np.flatnonzero(mask).astype(np.int32),
                                   device=device)

        return SpmmLayout(
            n=n,
            in_ptr=torch.as_tensor(ptr.astype(np.int32), device=device),
            in_idx=torch.as_tensor(np.asarray(src, np.int32)[order],
                                   device=device),
            w=torch.as_tensor(np.asarray(w, np.float32)[order],
                              device=device),
            heavy=ids(deg > HEAVY_DEGREE), light=ids(deg <= HEAVY_DEGREE))

    @staticmethod
    def pull(g: csr.Graph, sqrt_c: float, device) -> "SpmmLayout":
        """Â over the in-CSR (the graph's edge list is grouped by
        destination, so each row keeps the in-CSR's edge order)."""
        return SpmmLayout.from_edges(g.edge_src, g.edge_dst,
                                     csr.normalized_pull_weights(g, sqrt_c),
                                     g.n, device)

    @staticmethod
    def push(g: csr.Graph, sqrt_c: float, device) -> "SpmmLayout":
        """The transpose of Â over the out-CSR: out-edge u -> v carries
        sqrt(c)/|I(v)|, the pull weight of its destination."""
        return SpmmLayout.from_edges(g.edge_dst, g.edge_src,
                                     csr.normalized_pull_weights(g, sqrt_c),
                                     g.n, device)


def _graph_inputs(x, g: csr.Graph, w, device):
    """x as contiguous float32 on ``device`` (``cuda`` unless
    ``device="cpu"``) and the operator out[v] = sum_{u in I(v)} w_(u->v)
    x[u] there, ``w`` in the graph's edge order."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev, torch.float32).contiguous()
    return x, SpmmLayout.from_edges(g.edge_src, g.edge_dst, w, g.n, dev)


def spmm(x, g: csr.Graph, w: np.ndarray, *, device=None) -> torch.Tensor:
    """out[v] = sum_{u in I(v)} w_(u->v) * x[u] for x (n, F), through the
    ``spmm`` kernel on ``device``: the Hopper kernel on ``cuda`` (it
    raises if it cannot run), the plain version on the CPU."""
    return spmm_kernel(*_graph_inputs(x, g, w, device))


def spmm_reference(x, g: csr.Graph, w: np.ndarray, *,
                   device=None) -> torch.Tensor:
    """The plain version of :func:`spmm` on ``device``."""
    return spmm_plain(*_graph_inputs(x, g, w, device))
