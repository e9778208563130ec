"""Layout builder and Horner loop for the Horner-push step kernel.

Port of the layout and loop half of ``repro/kernels/horner_push/ops.py``. The
TPU layout groups edges into destination blocks for a one-hot matmul;
the port's layout is the graph's own CSR over destinations, the
``spmm`` kernel's :class:`~repro_torch.kernels.spmv_ell.ops.SpmmLayout`,
which the step kernel walks per output node, with the nodes split by
in-degree: a heavy node (in-degree above ``HEAVY_DEGREE``) gets a block
of its own.

The Horner recursion runs the reference's uniform form

    acc = 0;  for l = l_max .. 0:  acc = Â prune_tau(acc) + seed_l

over two ping-ponged node-major (n, B) buffers (``horner_steps``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.kernels.horner_push.horner_push import horner_steps
from repro_torch.kernels.spmv_ell.ops import SpmmLayout


def prepare_rows(ku: torch.Tensor, xu: torch.Tensor, d: torch.Tensor,
                 n: int):
    """Packed rows (B, W) -> (keys sorted per row, contrib = vals * d_k
    in the same order), both contiguous; PAD slots carry contrib 0."""
    ks = (ku.long() % n).clamp_(0, n - 1)
    contrib = torch.where(ku == INT32_PAD_KEY, 0.0, xu * d[ks])
    keys, perm = torch.sort(ku, dim=1, stable=True)
    return keys.contiguous(), contrib.gather(1, perm).contiguous()


def horner_push(ku, xu, d, layout: SpmmLayout, tau: float, *, n: int,
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
