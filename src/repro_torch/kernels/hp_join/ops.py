"""The sqrt(d) fold that prepares a packed table for the join kernel,
and the batched pair queries of an index through the kernel or its
plain version.

Port of ``repro/kernels/hp_join/ops.py``. ``fold_sqrt_d``: since
h_u * d_k * h_v = (h_u sqrt(d_k)) * (h_v sqrt(d_k)) and d_k >= 1 - c > 0,
values are multiplied by sqrt(d_k) once, at install, and the join
needs no d gather. ``query_pairs_kernel`` / ``query_pairs_reference``
are the reference's kernel-level entries; its Pallas tiling arguments
(``bq``, ``interpret``) have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.kernels.hp_join.hp_join import hp_join, hp_join_plain


def fold_sqrt_d(index, *, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, folded values) of an index's packed table, ready for the
    join kernel, on ``device`` (``cuda`` unless ``device="cpu"``): the
    reference's call and result, as tensors where it returns NumPy
    arrays (the same bits)."""
    keys, vals, d = index.device_arrays(device)
    return keys, fold_sqrt_d_arrays(keys, vals, d)


def fold_sqrt_d_arrays(keys: torch.Tensor, vals: torch.Tensor,
                       d: torch.Tensor) -> torch.Tensor:
    """The folded values of a packed table -- ``vals * sqrt(d_k)`` at
    each entry's key, 0 at PAD -- where the tensors lie. Computed in
    float64, stored as float32."""
    n = d.numel()
    ks = (keys.long() % n).clamp_(0, n - 1)
    sd = torch.sqrt(d.double().clamp(min=0.0))
    folded = (vals.double() * sd[ks]).float()
    folded[keys == INT32_PAD_KEY] = 0.0
    return folded


def _pair_inputs(index, us, vs, device):
    """The index's keys and folded values on ``device`` (``cuda`` unless
    ``device="cpu"``; the upload is cached per index epoch) and the pair
    ids as int32 there."""
    index.refuse_reduced("query_pairs_kernel")
    keys, folded = fold_sqrt_d(index, device=device)
    ids = [torch.as_tensor(np.asarray(x, np.int32), device=keys.device)
           for x in (us, vs)]
    return keys, folded, *ids


def query_pairs_kernel(index, us, vs, *, device=None) -> np.ndarray:
    """(B,) float32 scores of the pairs (us[b], vs[b]) through the join
    kernel (``hp_join``) on ``device``: the Hopper kernel on ``cuda``
    (it raises if it cannot run), the plain version on the CPU."""
    return hp_join(*_pair_inputs(index, us, vs, device)).cpu().numpy()


def query_pairs_reference(index, us, vs, *, device=None) -> np.ndarray:
    """The plain version of :func:`query_pairs_kernel` on ``device``."""
    return hp_join_plain(*_pair_inputs(index, us, vs,
                                       device)).cpu().numpy()
