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

The node-sharded push runs over node slabs (:class:`Slab`):
:func:`horner_push_slabs_plain`, the plain version of
``horner_push.horner_push_slabs``, reads the query rows from a row
source by owner (:func:`rows_by_owner`) and runs a range of levels,
each one :func:`horner_slab_step_plain` a slab, into the shared
node-major frontier.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.kernels.cost import host_read, is_fake, worst_case
from repro_torch.kernels.spmv_ell import spmm_plain
from repro_torch.kernels.spmv_ell.ops import SpmmLayout

# the kernel's caps: slabs a launch (its table is passed by value) and
# segments of a row source
MAX_SLABS = 16
MAX_SEGMENTS = 16


@dataclasses.dataclass(frozen=True)
class Slab:
    """One node slab of a sharded push: its rows [start, start +
    layout.n) of the node dimension, the CSR of their in-edges
    (``layout``, whose ``in_idx`` are global rows of the frontier), and
    the d it reads at k - ``d_offset``."""
    layout: SpmmLayout
    d: torch.Tensor
    start: int
    d_offset: int

    def __post_init__(self):
        """Check d once, here (the layout checked its own arrays), so
        that a push checks only its per-call arguments."""
        if self.d.dtype != torch.float32 or self.d.dim() != 1 or \
                not self.d.is_contiguous() or \
                self.d.device != self.layout.device:
            raise ValueError("a Slab's d must be a contiguous float32 "
                             "vector on its layout's device")
        if self.start < 0 or self.start < self.d_offset:
            raise ValueError(f"a Slab starts at a row >= 0 and >= its "
                             f"d_offset: start {self.start}, d_offset "
                             f"{self.d_offset}")

    @property
    def device(self) -> torch.device:
        return self.layout.device


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


def rows_by_owner(rows, us: torch.Tensor):
    """The query rows (B, W) of the ids ``us``, each read from the
    segment (keys, vals, base) of the row source ``rows`` that holds it
    (ids [base, base + len(keys)), every segment on ``us``'s device); an
    id that no segment holds gets an all-PAD row. What the kernel's
    prologue reads through the ids."""
    B = us.shape[0]
    W = rows[0][0].shape[1] if rows else 0
    ku = torch.full((B, W), INT32_PAD_KEY, dtype=torch.int32,
                    device=us.device)
    xu = torch.zeros((B, W), dtype=torch.float32, device=us.device)
    for keys, vals, base in rows:
        u = us.long() - int(base)
        mine = ((u >= 0) & (u < keys.shape[0]))[:, None]
        uc = u.clamp(0, keys.shape[0] - 1)
        ku = torch.where(mine, keys[uc], ku)
        xu = torch.where(mine, vals[uc], xu)
    return ku, xu


def top_level(keys: torch.Tensor, n: int, l_max: int) -> int:
    """The highest level (key // n, at most l_max) that holds a key in
    the rows ``keys``, -1 for none: above it a push from a zero frontier
    stays exactly zero (one host sync). Fake rows (the dry run's) hold
    no keys: l_max, the worst case, and the host read is declared
    (``kernels/cost.host_read``) in place of the one made."""
    if is_fake(keys):
        worst_case("top_level: the rows' highest level taken as l_max")
        host_read("_local_scalar_dense")
        return l_max
    lv = keys.long() // n
    lv = torch.where((keys == INT32_PAD_KEY) | (lv > l_max), -1, lv)
    return int(lv.max()) if lv.numel() else -1


def horner_push_slabs_plain(rows, us, slabs, outs, tau: float, *, n: int,
                            l_max: int, hi: int | None = None, lo: int = 0,
                            bf16_frontier: bool = False,
                            n_rows: int | None = None,
                            workspace: torch.Tensor | None = None) -> None:
    """The plain version of ``horner_push.horner_push_slabs``, with the
    same arguments: the rows by owner (:func:`rows_by_owner`), the top
    level (:func:`top_level`), then for each level of [min(hi, top) ..
    lo] one :func:`horner_slab_step_plain` a slab -- from the frontier
    buffer (level + 1) & 1 below the top, from zero at it -- written to
    buffer level & 1 at the slab's global rows (through bfloat16 under
    ``bf16_frontier``), or at level 0 into the slab's ``outs``."""
    B = us.shape[0]
    hi = l_max if hi is None else hi
    if n_rows is None:
        n_rows = max(sl.start + sl.layout.n for sl in slabs)
    dev = slabs[0].device
    if workspace is None:
        workspace = torch.zeros(2 * n_rows * B, dtype=torch.float32,
                                device=dev)
    front = workspace[:2 * n_rows * B].view(2, n_rows, B)
    ku, xu = rows_by_owner(rows, us)
    start = max(top_level(ku, n, l_max), 0)
    for level in range(min(hi, start), lo - 1, -1):
        x = front[(level + 1) & 1] if level < start else None
        for sl, out in zip(slabs, outs):
            res = horner_slab_step_plain(
                x, sl.layout, ku, xu, sl.d, level, tau, n=n,
                slab_start=sl.start, d_offset=sl.d_offset)
            if level == 0:
                out.copy_(res)
            else:
                if bf16_frontier:
                    res = res.to(torch.bfloat16).float()
                front[level & 1, sl.start:sl.start + sl.layout.n] = res


def count_hbm_intermediates(fn, *args, min_elems: int) -> int:
    """The frontier-sized (>= ``min_elems`` element) arrays that one call
    of ``fn(*args)`` writes, by the op walk: the kernel-fusion gate's
    count (``analysis/jaxpr_passes.count_hbm_intermediates``, which this
    delegates to)."""
    from repro_torch.analysis import jaxpr_passes
    return jaxpr_passes.count_hbm_intermediates(fn, *args,
                                                min_elems=min_elems)
