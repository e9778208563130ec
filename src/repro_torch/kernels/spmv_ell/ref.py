"""Plain torch oracle for the segment-sum SpMM, port of
``repro/kernels/spmv_ell/ref.py``'s ``spmm_ref``:

    out[v, :] = sum_{e : dst_e = v} w_e * x[src_e, :]

the pull operator Â behind both SLING's HP propagation (Equation 16 /
Algorithm 2) and GNN message passing, in any edge order. The blocked
oracle (``spmm_block_ref``) takes the Pallas layout, which the port
does not have.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import segment_sum


def spmm_ref(x, edge_src, edge_dst, w, n: int):
    """Plain segment-sum reference (any edge order)."""
    msgs = x.index_select(0, torch.as_tensor(edge_src).long()) * w[:, None]
    return segment_sum(msgs, torch.as_tensor(edge_dst), n)
