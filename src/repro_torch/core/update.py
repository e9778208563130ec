"""Incremental index maintenance for dynamic graphs.

Port of ``repro/core/update.py``. Every stored SLING quantity depends
on the graph only through in-neighbor lists (d_k reads I(k) and the
pair SimRank of I(k); an HP entry h~(v; l, k) reads I(w) along the
reverse walks v -> ... -> k; the pull weights are per edge), so a batch
of edge changes with touched in-neighborhoods T invalidates only state
whose walk mass crosses T. Three pruned mass scans
(``hp_index.propagation_mass``, each an Â chain through the ``spmm``
kernel on the card) and a row repair turn that into:

  rows R     = { v : discounted hitting mass of v onto T > theta_r }
               -- H(v) rows to re-derive (pull mass, old + new graph);
  targets K  = { k : walk-distribution mass from T at k > theta_r }
               -- the seed columns Alg 2 re-runs (push mass, old + new);
  d-nodes D  = T  union  { k : mean in-neighbor drift > max(theta_r,
               eps_d / 2c) } -- correction factors to re-estimate.

Entries of R toward K are repaired exactly (a from-scratch build's
values); the largest masses the thresholds skipped are measured and
charged to the plan's staleness reserve (``theory.stale_increment``).
Once the reserve is spent the report raises ``needs_rebuild``.

``update_index`` changes the index's device tensors in place (d, the
packed rows, the Section-5.3 marks of repaired rows, stale, epoch); a
serving ``QueryEngine`` holds its own copies and picks the repaired
state up with ``swap_index``. Quantized and mapped indexes are
read-only and refused before anything is written.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import diagonal, hp_index, theory
from repro_torch.device import synchronize
from repro_torch.graph import csr


@dataclasses.dataclass
class UpdateReport:
    """What one ``update_index`` batch did, and what it cost."""
    graph: csr.Graph            # post-delta graph (serve + next update)
    touched: np.ndarray         # nodes whose in-neighborhood changed
    rows_repaired: int          # |R|: HP rows re-derived
    targets_seeded: int         # |K|: Alg-2 columns re-run
    d_updated: int              # |D|: correction factors re-estimated
    width_grew: bool            # packed HPTable re-packed wider
    stale: float                # accumulated staleness after this batch
    eps_stale: float            # the plan's reserve (trigger level)
    needs_rebuild: bool         # stale > eps_stale: guarantee expired
    affected: np.ndarray        # R u D u T: nodes whose scores may move
    secs: dict                  # per-phase wall-clock breakdown

    @property
    def noop(self) -> bool:
        return len(self.touched) == 0


def affected_sets(g_old: csr.Graph, g_new: csr.Graph, touched: np.ndarray,
                  tv: np.ndarray, plan: theory.SlingPlan, theta_r: float,
                  block: int = 256, device=None):
    """(rows, targets, d_nodes, m_rows, m_d) for a touched set.

    The mass scans run on ``device`` (``cuda`` unless ``device="cpu"``),
    seeded with each touched node's transition perturbation ``tv``, on
    both graphs: the old graph finds state that must shrink or vanish,
    the new graph state that must appear; the elementwise max keeps both.
    ``m_rows`` / ``m_d`` are the largest drift proxies the thresholds
    skipped, the inputs to ``theory.stale_increment``. The rest is host
    NumPy on (n,) vectors, as in the reference.
    """
    sc, l_max = plan.sqrt_c, plan.l_max

    def both(transpose):
        a, b = (hp_index.propagation_mass(gr, touched, sc, theta_r, l_max,
                                          transpose=transpose, block=block,
                                          weights=tv, device=device)
                for gr in (g_old, g_new))
        return tuple(np.maximum(x, y) for x, y in zip(a, b))

    hitmax, hittot, hitskip = both(transpose=False)
    pushmax, _, pushskip = both(transpose=True)

    hot = hitmax > theta_r
    hot[touched] = True
    rows = np.flatnonzero(hot)
    targets = np.union1d(np.flatnonzero(pushmax > theta_r), touched)
    m_rows = float(max(hitskip.max(), pushskip.max(), 0.0))

    # d_k averages in-neighbor pair SimRank (Eq. 15), so its drift proxy
    # is the mean of the in-neighbors' kept plus first-generation pruned
    # hitting mass, thresholded at the eps_d scale
    n = g_new.n
    deg = np.maximum(g_new.in_deg, 1).astype(np.float64)
    hitdrift = hittot + hitskip
    nb_drift = np.zeros(n, np.float64)
    np.add.at(nb_drift, g_new.edge_dst, hitdrift[g_new.edge_src])
    nb_drift /= deg
    tau_d = max(theta_r, plan.eps_d / (2 * plan.c))
    d_hot = nb_drift > tau_d
    d_hot[touched] = True
    d_nodes = np.flatnonzero(d_hot)
    m_d = float(nb_drift[~d_hot].max()) if (~d_hot).any() else 0.0
    return rows, targets, d_nodes, m_rows, m_d


def update_index(idx, g: csr.Graph, delta: csr.GraphDelta, seed: int = 0,
                 exact_d: bool = False, theta_r: float | None = None,
                 block: int = 256, verbose: bool = False) -> UpdateReport:
    """Apply a batched edge delta to ``idx`` without a full rebuild, on
    the index's device.

    Changes ``idx`` in place (d, packed HP rows, stale, epoch) and
    returns an :class:`UpdateReport` with the post-delta graph and the
    affected-node set for ``QueryEngine.swap_index``. ``exact_d=True``
    recomputes the affected correction factors with the power method
    (small graphs; the tests' zero-Monte-Carlo-error mode). Repaired
    rows equal a from-scratch build on the new graph for every target
    in K; the remainder is charged by ``theory.stale_increment`` to
    ``idx.stale``, and ``needs_rebuild`` is set once it exceeds
    ``plan.eps_stale``. ``secs`` holds the wall seconds of the phases
    apply_edges, affected_sets, hp_repair and diagonal (each ends in a
    device synchronize). Refuses a quantized or mapped (read-only)
    index before it writes anything.
    """
    if idx.quant is not None or idx.read_only:
        raise ValueError(
            "quantized/mmap'd indexes are read-only: in-place row "
            "repair would write fp32 values into quantization codes "
            "or into a read-only mapping. Rebuild, or update the "
            "fp32 index and re-quantize/re-save.")
    plan = idx.plan
    dev = idx.device
    theta_r = plan.theta if theta_r is None else theta_r
    secs: dict[str, float] = {}

    t0 = time.perf_counter()
    g_new, touched, tv = csr.apply_edges(g, delta)
    secs["apply_edges"] = time.perf_counter() - t0
    if len(touched) == 0:
        return UpdateReport(
            graph=g_new, touched=touched, rows_repaired=0,
            targets_seeded=0, d_updated=0, width_grew=False,
            stale=idx.stale, eps_stale=plan.eps_stale,
            needs_rebuild=idx.stale > plan.eps_stale,
            affected=np.zeros(0, np.int64), secs=secs)

    t0 = time.perf_counter()
    rows, targets, d_nodes, m_rows, m_d = affected_sets(
        g, g_new, touched, tv, plan, theta_r, block=block, device=dev)
    secs["affected_sets"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stats = hp_index.repair_hp_rows(g_new, idx.hp, rows, targets,
                                    block=block)
    synchronize(dev)
    secs["hp_repair"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if exact_d:
        d_full = diagonal.exact_diagonal(g_new, plan.c)
        d_new = idx.d.cpu().numpy()
        d_new[d_nodes] = d_full[d_nodes].astype(np.float32)
    else:
        d_new = diagonal.estimate_diagonal(
            g_new, plan, seed=seed, nodes=d_nodes,
            d_init=idx.d.cpu().numpy(), device=dev)
    idx.d.copy_(torch.as_tensor(d_new, dtype=torch.float32))
    synchronize(dev)
    secs["diagonal"] = time.perf_counter() - t0

    # Section-5.3 marks point at entries the repair may have moved or
    # deleted; dropping them only forgoes an enhancement. The 5.2
    # ``reduced`` flags stay: a reduced row's step-1/2 entries are
    # re-materialized from the current graph at query time.
    if idx.marks is not None:
        idx.marks[rows] = -1

    idx.stale += theory.stale_increment(plan, theta_r, m_rows, m_d)
    idx.epoch += 1
    affected = np.union1d(np.union1d(rows, d_nodes), touched)
    rep = UpdateReport(
        graph=g_new, touched=touched, rows_repaired=stats["rows"],
        targets_seeded=stats["targets"], d_updated=int(len(d_nodes)),
        width_grew=stats["width_grew"], stale=idx.stale,
        eps_stale=plan.eps_stale, needs_rebuild=idx.stale > plan.eps_stale,
        affected=affected, secs=secs)
    if verbose:
        print(f"update_index: touched={len(touched)} rows={stats['rows']} "
              f"targets={stats['targets']} d={len(d_nodes)} "
              f"stale={idx.stale:.4f}/{plan.eps_stale:.4f} "
              f"{sum(secs.values()):.2f}s {secs}")
    return rep


def random_delta(g: csr.Graph, n_add: int, n_del: int,
                 seed: int = 0) -> csr.GraphDelta:
    """Random churn batch: ``n_del`` existing edges out, ``n_add``
    uniform non-self edges in (the same draws as the reference)."""
    rng = np.random.default_rng(seed)
    if n_del > 0 and g.m > 0:
        pick = rng.choice(g.m, size=min(n_del, g.m), replace=False)
        del_src = g.edge_src[pick].astype(np.int64)
        del_dst = g.edge_dst[pick].astype(np.int64)
    else:
        del_src = del_dst = np.zeros(0, np.int64)
    add_src = rng.integers(0, g.n, n_add, dtype=np.int64)
    add_dst = rng.integers(0, g.n, n_add, dtype=np.int64)
    ok = add_src != add_dst
    return csr.GraphDelta(add_src=add_src[ok], add_dst=add_dst[ok],
                          del_src=del_src, del_dst=del_dst)
