"""The plain PyTorch Horner push: row preparation, the per-level step,
the Horner loop, and the level runs that the kernel's prologue finds.

Port of the loop half of ``repro/kernels/horner_push/ops.py``. The TPU
layout groups edges into destination blocks for a one-hot matmul; the
port's layout is the graph's own CSR over destinations, the ``spmm``
kernel's :class:`~repro_torch.kernels.spmv_ell.ops.SpmmLayout`.

The Horner recursion runs the reference's uniform form

    acc = 0;  for l = l_max .. 0:  acc = Â prune_tau(acc) + seed_l

over two ping-ponged node-major (n, B) buffers (``horner_steps_plain``).
This is the CPU path, and the version the Hopper kernel
(``horner_push.horner_push_rows``) is held against on the card.

The node-sharded push runs one level on one node slab at a time
(:func:`horner_slab_step_plain`, the plain version of
``horner_push.horner_push_slab_step``) over rows that
:func:`slab_rows` prepares once a push.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.kernels.spmv_ell import spmm_plain
from repro_torch.kernels.spmv_ell.ops import SpmmLayout


def prepare_rows(ku: torch.Tensor, xu: torch.Tensor, d: torch.Tensor,
                 n: int):
    """Packed rows (B, W) -> (keys sorted per row, contrib = vals * d_k
    in the same order), both contiguous; PAD slots carry contrib 0."""
    ks = (ku.long() % n).clamp_(0, n - 1)
    contrib = torch.where(ku == INT32_PAD_KEY, 0.0, xu * d[ks])
    keys, perm = torch.sort(ku, dim=1, stable=True)
    return keys.contiguous(), contrib.gather(1, perm).contiguous()


def horner_step_plain(x, out, layout, keys, contrib, level: int,
                      tau: float) -> torch.Tensor:
    """One plain step: prune, CSR pull (``spmm_plain``), and the
    level-l seed scattered with ``index_add_``; written into ``out``."""
    n, B = x.shape
    acc = spmm_plain(torch.where(x > tau, x, 0.0), layout)
    hit = (keys != INT32_PAD_KEY) & (keys.long() // n == level)
    b_idx, j_idx = torch.nonzero(hit, as_tuple=True)
    seed = torch.zeros(n * B, dtype=torch.float32, device=x.device)
    seed.index_add_(0, (keys[b_idx, j_idx].long() % n) * B + b_idx,
                    contrib[b_idx, j_idx])
    return out.copy_(acc + seed.view(n, B))


def horner_steps_plain(acc, spare, layout, keys, contrib, l_max: int,
                       tau: float) -> torch.Tensor:
    """Levels l_max .. 0 from the frontier ``acc`` (node-major (n, B)),
    ping-ponging ``acc`` and ``spare`` with :func:`horner_step_plain`;
    returns the buffer that holds the result."""
    for level in range(l_max, -1, -1):
        horner_step_plain(acc, spare, layout, keys, contrib, level, tau)
        acc, spare = spare, acc
    return acc


def horner_push(ku, xu, d, layout: SpmmLayout, tau: float, *, n: int,
                l_max: int) -> torch.Tensor:
    """Plain Horner push for a batch of packed rows in any order: (B, W)
    keys ``ku`` and values ``xu`` -> (B, n) float32 scores."""
    keys, contrib = prepare_rows(ku, xu, d, n)
    acc = torch.zeros((n, ku.shape[0]), dtype=torch.float32,
                      device=ku.device)
    out = horner_steps_plain(acc, torch.empty_like(acc), layout, keys,
                             contrib, l_max, float(np.float32(tau)))
    return out.t().contiguous()


def level_runs_plain(keys: torch.Tensor, n: int, l_max: int):
    """What the kernel's prologue finds in rows ``keys`` (B, W), each
    sorted ascending with PAD last: ``runs`` (B, l_max + 2) int64, where
    ``runs[b, l]`` is the first j whose level (key // n, PAD counted as
    l_max + 1) is >= l, so level l's entries are ``runs[b, l] ..
    runs[b, l + 1] - 1``; and ``last`` (B,) int64, the level of each
    row's last entry, -1 for an all-PAD row. A push from a zero frontier
    is exactly zero above ``last.max()``."""
    B, W = keys.shape
    if W == 0:
        return (torch.zeros((B, l_max + 2), dtype=torch.long,
                            device=keys.device),
                torch.full((B,), -1, dtype=torch.long, device=keys.device))
    lv = torch.where(keys == INT32_PAD_KEY, l_max + 1,
                     (keys.long() // n).clamp(max=l_max + 1))
    bounds = torch.arange(l_max + 2, device=keys.device)
    runs = torch.searchsorted(lv.contiguous(),
                              bounds.expand(B, -1).contiguous())
    count = runs[:, -1:]
    last = torch.where(count > 0, lv.gather(1, (count - 1).clamp(min=0)),
                       -1).flatten()
    return runs, last


def slab_rows(ku: torch.Tensor, xu: torch.Tensor, n: int, l_max: int):
    """The query rows (B, W) as the slab step reads them: keys sorted per
    row (PAD last) and the values in the same order, both contiguous;
    their level runs (B, l_max + 2) int32 (:func:`level_runs_plain`);
    and the highest level that holds a seed in any row (-1 for none),
    above which a push from a zero frontier stays exactly zero."""
    keys, perm = torch.sort(ku, dim=1, stable=True)
    runs, last = level_runs_plain(keys, n, l_max)
    return (keys.contiguous(), xu.gather(1, perm).contiguous(),
            runs.int().contiguous(),
            int(last.max()) if last.numel() else -1)


def horner_slab_step_plain(x, layout: SpmmLayout, keys, vals, d,
                           level: int, tau: float, *, n: int,
                           slab_start: int, d_offset: int,
                           out: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """One Horner level on the slab [slab_start, slab_start + n_loc) of
    a graph of ``n`` nodes, n_loc = ``layout.n``: the CSR pull
    (``spmm_plain``) of the pruned node-major frontier ``x`` (rows, B),
    whose rows the layout's global ``in_idx`` address (None: a zero
    frontier), plus the level's seed, ``vals[b, j] * d[k - d_offset]`` at
    every key l*n + k of row b with l = ``level`` and k in the slab,
    added up with ``index_add_``; written into ``out`` (n_loc, B) when
    given. The pull, then the seed, as in :func:`horner_step_plain`."""
    n_loc, B = layout.n, keys.shape[0]
    dev = keys.device
    acc = (torch.zeros((n_loc, B), dtype=torch.float32, device=dev)
           if x is None else
           spmm_plain(torch.where(x > tau, x, 0.0), layout))
    k = keys.long() % n
    hit = ((keys != INT32_PAD_KEY) & (keys.long() // n == level)
           & (k >= slab_start) & (k < slab_start + n_loc))
    b_idx, j_idx = torch.nonzero(hit, as_tuple=True)
    kk = k[b_idx, j_idx]
    seed = torch.zeros(n_loc * B, dtype=torch.float32, device=dev)
    seed.index_add_(0, (kk - slab_start) * B + b_idx,
                    vals[b_idx, j_idx] * d[kk - d_offset])
    res = acc + seed.view(n_loc, B)
    return res if out is None else out.copy_(res)
