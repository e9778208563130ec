"""Layout builder and Horner loop for the Horner-push step kernel.

Port of the layout and loop half of ``repro/kernels/horner_push/ops.py``. The
TPU layout groups edges into destination blocks for a one-hot matmul;
the port's layout is the graph's own CSR over destinations
(:class:`PushLayout`), which the step kernel walks per output node,
with the nodes split by in-degree: a heavy node (in-degree above
``HEAVY_DEGREE``) gets a block of its own.

The Horner recursion runs the reference's uniform form

    acc = 0;  for l = l_max .. 0:  acc = Â prune_tau(acc) + seed_l

over two ping-ponged node-major (n, B) buffers (``horner_steps``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.graph import csr
from repro_torch.kernels.horner_push.horner_push import horner_steps

# in-degree above which the step kernel gives a node a block of its own
HEAVY_DEGREE = 32


@dataclasses.dataclass(frozen=True)
class PushLayout:
    """Â in CSR over destinations on one device (int32 for the kernel),
    and the node ids split by in-degree."""
    n: int
    in_ptr: torch.Tensor   # (n+1,) int32
    in_idx: torch.Tensor   # (m,) int32 edge sources, grouped by dst
    w: torch.Tensor        # (m,) float32 per-edge pull weights
    heavy: torch.Tensor    # int32 ids with in-degree > HEAVY_DEGREE
    light: torch.Tensor    # int32 ids of the other nodes

    @staticmethod
    def from_edges(src, dst, w, n: int, device) -> "PushLayout":
        """Any edge list (src -> dst, weight w): edges are grouped by
        destination with a stable sort, so each node's in-edges keep
        their input order."""
        dst = np.asarray(dst, np.int64)
        order = np.argsort(dst, kind="stable")
        deg = np.bincount(dst, minlength=n)
        ptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=ptr[1:])

        def ids(mask):
            return torch.as_tensor(np.flatnonzero(mask).astype(np.int32),
                                   device=device)

        return PushLayout(
            n=n,
            in_ptr=torch.as_tensor(ptr.astype(np.int32), device=device),
            in_idx=torch.as_tensor(np.asarray(src, np.int32)[order],
                                   device=device),
            w=torch.as_tensor(np.asarray(w, np.float32)[order],
                              device=device),
            heavy=ids(deg > HEAVY_DEGREE), light=ids(deg <= HEAVY_DEGREE))

    @staticmethod
    def from_graph(g: csr.Graph, sqrt_c: float, device) -> "PushLayout":
        return PushLayout.from_edges(g.edge_src, g.edge_dst,
                                     csr.normalized_pull_weights(g, sqrt_c),
                                     g.n, device)


def prepare_rows(ku: torch.Tensor, xu: torch.Tensor, d: torch.Tensor,
                 n: int):
    """Packed rows (B, W) -> (keys sorted per row, contrib = vals * d_k
    in the same order), both contiguous; PAD slots carry contrib 0."""
    ks = (ku.long() % n).clamp_(0, n - 1)
    contrib = torch.where(ku == INT32_PAD_KEY, 0.0, xu * d[ks])
    keys, perm = torch.sort(ku, dim=1, stable=True)
    return keys.contiguous(), contrib.gather(1, perm).contiguous()


def horner_push(ku, xu, d, layout: PushLayout, tau: float, *, n: int,
                l_max: int, steps=horner_steps) -> torch.Tensor:
    """Horner push for a batch of packed rows: (B, W) keys ``ku`` and
    values ``xu`` -> (B, n) float32 scores. ``steps`` runs the levels:
    the kernel wrapper (default) or ``horner_steps_plain``."""
    keys, contrib = prepare_rows(ku, xu, d, n)
    acc = torch.zeros((n, ku.shape[0]), dtype=torch.float32,
                      device=ku.device)
    out = steps(acc, torch.empty_like(acc), layout, keys, contrib, l_max,
                float(np.float32(tau)))
    return out.t().contiguous()
