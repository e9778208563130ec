"""Index construction: plan -> diagonal (Alg 4) -> HP table (Alg 2).

Port of ``repro/core/build.py`` ``build_index`` for ``builder="sling"``
on one device. The walks and the HP build run on ``device`` (``cuda``
unless the caller passes ``device="cpu"``); ``exact_d=True`` takes the
power-method diagonal on the host instead of the walks.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import diagonal, hp_index, theory
from repro_torch.core.index import SlingIndex
from repro_torch.device import resolve_device
from repro_torch.graph import csr


def build_index(g: csr.Graph, eps: float = 0.025, c: float = 0.6,
                seed: int = 0, block: int = 256, exact_d: bool = False,
                device=None, verbose: bool = False) -> SlingIndex:
    dev = resolve_device(device)
    p = theory.plan(eps=eps, c=c, n=g.n)
    t0 = time.perf_counter()
    if exact_d:
        d = diagonal.exact_diagonal(g, c)
    else:
        d = diagonal.estimate_diagonal(g, p, seed=seed, device=dev,
                                       verbose=verbose)
    t1 = time.perf_counter()
    hp = hp_index.build_hp_table(g, theta=p.theta, sqrt_c=p.sqrt_c,
                                 l_max=p.l_max, block=block, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    idx = SlingIndex(plan=p, d=torch.as_tensor(d, dtype=torch.float32,
                                               device=dev), hp=hp,
                     build_seconds={"d": t1 - t0, "hp": t2 - t1})
    if verbose:
        print(f"build_index: d={t1 - t0:.2f}s hp={t2 - t1:.2f}s "
              f"entries={int(hp.counts.sum())} width={hp.width} "
              f"bytes={idx.nbytes()}")
    return idx
