"""PRSim-style hub-decomposed HP construction (DESIGN.md §15).

Port of ``repro/prsim/builder.py``. The entries are exactly those of
SLING's pruned Alg-2 propagation (strict ``> theta``, Lemma 7), only
*scheduled* around the graph's hubs:

  1. reverse PageRank ranks every node (``prsim/pagerank.py``);
  2. the hub set is the smallest high-PR prefix covering ``hub_mass``
     of the PR mass, capped at ``hub_cap_frac * n`` nodes;
  3. hub columns -- whose frontiers go dense -- propagate in batches of
     ``hub_batch``, so the live frontier stays a few dense columns;
  4. the tail propagates in sparse blocks of ``tail_block``.

Both run through ``hp_index._sparse_targets_coo``, whose float64 sums
do not depend on how the columns are batched, so the triples equal the
SLING sparse schedule's bit for bit and the packed artifact differs
only in its recorded builder.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.core import hp_index, theory
from repro_torch.device import resolve_device
from repro_torch.graph import csr
from repro_torch.prsim.pagerank import DEFAULT_DAMPING, reverse_pagerank

DEFAULT_HUB_MASS = 0.5       # PR mass the hub set must cover ...
DEFAULT_HUB_CAP_FRAC = 0.05  # ... capped at this node share
DEFAULT_HUB_BATCH = 128      # hub columns per propagation batch
DEFAULT_TAIL_BLOCK = 4096    # tail columns per sparse block


@dataclasses.dataclass(frozen=True)
class PrsimStats:
    """Build-phase accounting returned by :func:`build_prsim_coo`."""
    n_hubs: int
    pr_iters: int
    hub_mass: float          # PR mass the chosen hub set covers
    pr_wall_s: float
    hub_wall_s: float
    tail_wall_s: float

    def as_row(self) -> dict:
        return {"n_hubs": self.n_hubs, "pr_iters": self.pr_iters,
                "hub_mass": round(self.hub_mass, 6),
                "pr_wall_s": round(self.pr_wall_s, 4),
                "hub_wall_s": round(self.hub_wall_s, 4),
                "tail_wall_s": round(self.tail_wall_s, 4)}


def hub_set(pr: np.ndarray, mass: float = DEFAULT_HUB_MASS,
            cap_frac: float = DEFAULT_HUB_CAP_FRAC) -> np.ndarray:
    """The smallest top-PR prefix covering ``mass`` of the PR mass,
    capped at ``ceil(cap_frac * n)`` nodes, sorted ascending (ties by
    node id through the stable sort)."""
    n = len(pr)
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(-pr, kind="stable")
    csum = np.cumsum(pr[order], dtype=np.float64)
    k = int(np.searchsorted(csum, mass * float(csum[-1]))) + 1
    cap = max(1, int(math.ceil(cap_frac * n)))
    k = max(1, min(k, cap, n))
    return np.sort(order[:k].astype(np.int64))


def prsim_hp_coo(g: csr.Graph, theta: float, sqrt_c: float, l_max: int,
                 sink: hp_index._CooSink, hub_ids: np.ndarray,
                 hub_batch: int = DEFAULT_HUB_BATCH,
                 tail_block: int = DEFAULT_TAIL_BLOCK,
                 progress: bool = False, device=None
                 ) -> tuple[float, float]:
    """Drive the hub/tail schedule on ``device`` into ``sink`` (host
    arrays); returns the (hub, tail) wall seconds. The sink sees every
    target column exactly once, so packing assembles the same rows as
    the SLING schedule."""
    n = g.n
    hp_index._check_key_space(n, l_max)
    og = hp_index.OutGraph.from_graph(g, sqrt_c, resolve_device(device))
    hub_ids = np.asarray(hub_ids, np.int64)
    mask = np.ones(n, bool)
    mask[hub_ids] = False
    tail = np.flatnonzero(mask)
    seq = 0
    walls = []
    for ids, step, what in ((hub_ids, hub_batch, "hub batch"),
                            (tail, tail_block, "tail block")):
        t0 = time.perf_counter()
        for i in range(0, len(ids), step):
            sink.add(seq, *(hp_index._host(t) for t in
                            hp_index._sparse_targets_coo(
                                og, ids[i:i + step], theta, l_max)))
            seq += 1
            if progress and (i // step) % 8 == 0:
                print(f"  prsim {what} {i}/{len(ids)}")
        walls.append(time.perf_counter() - t0)
    return walls[0], walls[1]


def build_prsim_coo(g: csr.Graph, plan: theory.SlingPlan,
                    sink: hp_index._CooSink,
                    hub_mass: float = DEFAULT_HUB_MASS,
                    hub_cap_frac: float = DEFAULT_HUB_CAP_FRAC,
                    hub_batch: int = DEFAULT_HUB_BATCH,
                    tail_block: int = DEFAULT_TAIL_BLOCK,
                    damping: float = DEFAULT_DAMPING,
                    progress: bool = False, device=None) -> PrsimStats:
    """The prsim front half on ``device``: reverse PageRank, the hub
    set, then hub and tail propagation into ``sink``. The back half
    (packing or v3 streaming) is the SLING builder's."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    pr, iters = reverse_pagerank(g, damping=damping, device=dev)
    hubs = hub_set(pr, mass=hub_mass, cap_frac=hub_cap_frac)
    t1 = time.perf_counter()
    if progress:
        print(f"  prsim: {len(hubs)} hubs cover "
              f"{float(pr[hubs].sum()):.3f} PR mass "
              f"({iters} PR iters, {t1 - t0:.2f}s)")
    hub_wall, tail_wall = prsim_hp_coo(
        g, plan.theta, plan.sqrt_c, plan.l_max, sink, hubs,
        hub_batch=hub_batch, tail_block=tail_block, progress=progress,
        device=dev)
    return PrsimStats(n_hubs=int(len(hubs)), pr_iters=int(iters),
                      hub_mass=float(pr[hubs].sum()),
                      pr_wall_s=t1 - t0, hub_wall_s=hub_wall,
                      tail_wall_s=tail_wall)
