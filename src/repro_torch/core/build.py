"""Index construction: plan -> diagonal (Alg 4) -> HP table (Alg 2).

Port of ``repro/core/build.py`` ``build_index`` for ``builder="sling"``
on one device. The walks and the HP build run on ``device`` (``cuda``
unless the caller passes ``device="cpu"``); ``exact_d=True`` takes the
power-method diagonal on the host instead of the walks.
``update_index`` is the facade over ``core/update.py``.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import (diagonal, hp_index, optimizations, theory,
                              update)
from repro_torch.core.index import SlingIndex
from repro_torch.device import resolve_device, synchronize
from repro_torch.graph import csr


def build_index(g: csr.Graph, eps: float = 0.025,
                delta: float | None = None, c: float = 0.6, seed: int = 0,
                adaptive: bool = True, block: int = 256, *,
                space_reduce: bool = False, enhance: bool = False,
                exact_d: bool = False, stale_frac: float = 0.0,
                quant_frac: float = 0.0, device=None,
                verbose: bool = False) -> SlingIndex:
    """The reference's positional order through ``block``. ``delta`` is
    the failure probability of the walk diagonal (``None``: 1/n) and
    ``adaptive`` picks Algorithm 4 over the fixed-budget Algorithm 1
    (``theory.plan``, ``diagonal.estimate_diagonal``). Everything after
    ``block`` is keyword-only: the reference's next positional
    parameter, ``spill_dir``, is not ported. ``stale_frac`` reserves
    that share of eps for the staleness that ``update_index`` batches
    spend, and ``quant_frac`` a share for ``quantize.quantize_index``
    (``theory.plan``'s ``eps_quant_frac``). ``space_reduce`` and
    ``enhance`` apply the Section-5.2 and 5.3 optimizations
    (``core/optimizations.py``) on the host after the build."""
    dev = resolve_device(device)
    p = theory.plan(eps=eps, delta=delta, c=c, n=g.n,
                    stale_frac=stale_frac, eps_quant_frac=quant_frac)
    t0 = time.perf_counter()
    if exact_d:
        d = diagonal.exact_diagonal(g, c)
    else:
        d = diagonal.estimate_diagonal(g, p, seed=seed, adaptive=adaptive,
                                       device=dev, verbose=verbose)
    t1 = time.perf_counter()
    hp = hp_index.build_hp_table(g, theta=p.theta, sqrt_c=p.sqrt_c,
                                 l_max=p.l_max, block=block, device=dev)
    synchronize(dev)
    t2 = time.perf_counter()
    idx = SlingIndex(plan=p, d=torch.as_tensor(d, dtype=torch.float32,
                                               device=dev), hp=hp,
                     build_seconds={"d": t1 - t0, "hp": t2 - t1})
    if space_reduce:
        optimizations.apply_space_reduction(idx, g)
    if enhance:
        optimizations.mark_for_enhancement(idx, g)
    if verbose:
        print(f"build_index: d={t1 - t0:.2f}s hp={t2 - t1:.2f}s "
              f"entries={int(hp.counts.sum())} width={hp.width} "
              f"bytes={idx.nbytes()}")
    return idx


def update_index(idx: SlingIndex, g: csr.Graph, delta, seed: int = 0,
                 exact_d: bool = False, theta_r: float | None = None,
                 block: int = 256, verbose: bool = False):
    """Incremental maintenance: apply a :class:`~repro_torch.graph.csr.
    GraphDelta` to ``idx`` in place without a full rebuild; returns the
    ``UpdateReport`` (new graph, affected nodes for
    ``QueryEngine.swap_index``, staleness, ``needs_rebuild``). Build
    with ``stale_frac > 0`` to reserve the budget updates spend."""
    return update.update_index(idx, g, delta, seed=seed, exact_d=exact_d,
                               theta_r=theta_r, block=block,
                               verbose=verbose)
