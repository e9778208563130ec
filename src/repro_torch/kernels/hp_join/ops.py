"""The sqrt(d) fold that prepares a packed table for the join kernel.

Port of ``repro/kernels/hp_join/ops.py`` ``fold_sqrt_d``: since
h_u * d_k * h_v = (h_u sqrt(d_k)) * (h_v sqrt(d_k)) and d_k >= 1 - c > 0,
values are multiplied by sqrt(d_k) once, at install, and the join
needs no d gather.
"""
from __future__ import annotations

import torch

from repro_torch.core.hp_index import INT32_PAD_KEY


def fold_sqrt_d(index):
    """(keys, folded_vals) of ``index``'s packed table, on its device;
    PAD slots carry value 0. Computed in float64, stored as float32."""
    n = index.n
    keys = index.hp.keys
    ks = (keys.long() % n).clamp_(0, n - 1)
    sd = torch.sqrt(index.d.double().clamp(min=0.0))
    folded = (index.vals_f32().double() * sd[ks]).float()
    folded[keys == INT32_PAD_KEY] = 0.0
    return keys, folded
