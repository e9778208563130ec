"""Correction-factor (d_k) estimation: Algorithms 1 and 4 on the device.

Port of ``repro/core/diagonal.py``:

    d_k = 1 - c/|I(k)| - c * mu_k,  mu_k = mean over in-neighbor pairs
    (i != j drawn uniformly with replacement) of s(v_i, v_j).  (Eq. 14-15)

The reference draws every start pair on the host before it walks
(phase 1 alone is len(nodes) * n_r1 pairs: ~4.6e8 on a 36,692-node
graph at eps = 0.025). Here each chunk of ``chunk`` pairs is drawn on
the device from a ``torch.Generator``: a pair's node comes from its
global index (a ``searchsorted`` over the per-node budgets), its two
in-neighbors from uniforms, and the meet counts are summed per node
with ``bincount`` before the next chunk. Peak memory is O(chunk).

Exact shortcuts (as the reference): in-degree 0 gives d_k = 1,
in-degree 1 gives d_k = 1 - c.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.baselines import power
from repro_torch.core import theory, walks
from repro_torch.device import resolve_device
from repro_torch.graph import csr
from repro_torch.launch.mesh import mesh_device


def _count_meets(dg: walks.DeviceGraph, nodes: torch.Tensor,
                 counts: np.ndarray, gen: torch.Generator, sqrt_c: float,
                 t_max: int, chunk: int, mesh=None,
                 mesh_axis: str = "data") -> np.ndarray:
    """Meets per node over ``counts[i]`` start pairs for ``nodes[i]``.

    A pair draws two uniform in-edge positions of the node. Two draws of
    the same position are samples that do not meet (Alg 1 line 5: that
    case is the c/|I(k)| term of Eq. 14). Two distinct positions holding
    the same node -- parallel edges of a multigraph -- meet at step 0,
    as ``exact_diagonal`` counts them (s(x, x) = 1 for i != j).
    """
    counts_t = torch.as_tensor(counts, dtype=torch.int64, device=dg.device)
    ends = torch.cumsum(counts_t, 0)
    total = int(counts.sum())
    cnt = torch.zeros(len(counts), dtype=torch.int64, device=dg.device)
    for lo in range(0, total, chunk):
        hi = min(total, lo + chunk)
        p = torch.arange(lo, hi, dtype=torch.int64, device=dg.device)
        seg = torch.searchsorted(ends, p, right=True)
        ks = nodes[seg]
        r = torch.rand((2, hi - lo), generator=gen, device=dg.device)
        oa = walks.in_edge_offsets(dg, ks, r[0])
        ob = walks.in_edge_offsets(dg, ks, r[1])
        base = dg.in_ptr[ks]
        met = walks.paired_meet(dg.in_ptr, dg.in_idx, dg.in_deg,
                                dg.in_idx[base + oa],
                                dg.in_idx[base + ob], gen, sqrt_c, t_max,
                                mesh=mesh, mesh_axis=mesh_axis)
        met &= oa != ob
        cnt.index_add_(0, seg, met.long())    # integer sums: exact
    return cnt.cpu().numpy()


def estimate_diagonal(g: csr.Graph, plan: theory.SlingPlan,
                      seed: int = 0, adaptive: bool = True,
                      chunk: int = walks.DEFAULT_CHUNK,
                      dg: walks.DeviceGraph | None = None,
                      nodes=None, d_init=None, mesh=None,
                      mesh_axis: str = "data", *, device=None,
                      verbose: bool = False) -> np.ndarray:
    """Estimate all d_k on ``device`` (``cuda`` unless ``device="cpu"``);
    ``adaptive=True`` is Algorithm 4, False the fixed-budget Algorithm 1.
    Returns (n,) float32 (host). The positional order is the
    reference's. ``verbose`` prints each phase's walk-pair count and
    seconds.

    ``nodes`` restricts estimation to a subset (incremental maintenance
    re-estimates only the affected d_k of an edge batch): entries
    outside ``nodes`` come back bit-equal to ``d_init`` (required with
    ``nodes``), and the walks run on the current graph ``g``, so subset
    estimates carry the same certificate as a full pass. ``dg`` is
    ``g`` already on ``device`` (made here when None).

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) splits every
    walk chunk over ``mesh.shape[mesh_axis]`` shards
    (:func:`walks.paired_meet`); the random numbers are drawn once on
    the axis's first device, which is where the estimate runs, so every
    meet indicator, and d, equals the unsharded estimate's bit for bit.
    ``device`` is then that first device or None."""
    if mesh is not None:
        walks.check_walk_mesh(mesh, mesh_axis, chunk)
        device = mesh_device(mesh, mesh_axis, device)
    n, c, sc = g.n, plan.c, plan.sqrt_c
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if dg is None:
        dg = walks.DeviceGraph.from_graph(g, device=device)

    deg = g.in_deg
    if nodes is None:
        d = np.ones(n, dtype=np.float64)
        d[deg == 1] = 1.0 - c
        sampled = np.flatnonzero(deg >= 2)
    else:
        if d_init is None:
            raise ValueError("subset estimation needs d_init")
        nodes = np.asarray(nodes, np.int64)
        d = np.asarray(d_init).astype(np.float64)
        d[nodes] = 1.0
        d[nodes[deg[nodes] == 1]] = 1.0 - c
        sampled = nodes[deg[nodes] >= 2]
    if len(sampled) == 0:
        return d.astype(np.float32)
    nodes = torch.as_tensor(sampled, dtype=torch.int64, device=device)

    n_r1 = (plan.n_r1 if adaptive
            else theory.alg1_pairs(plan.eps_d, plan.delta_d, c))
    counts = np.full(len(sampled), n_r1, dtype=np.int64)
    t0 = time.perf_counter()
    cnt1 = _count_meets(dg, nodes, counts, gen, sc, plan.t_max, chunk,
                        mesh, mesh_axis)
    mu_hat = cnt1 / n_r1
    if verbose:
        print(f"  diagonal phase 1: {int(counts.sum())} walk pairs over "
              f"{len(sampled)} nodes in {time.perf_counter() - t0:.2f}s")

    if adaptive:
        # phase 2 (Alg 4 lines 12-19): only nodes with mu_hat > eps_d
        need = np.flatnonzero(mu_hat > plan.eps_d)
        if len(need):
            budget = theory.phase2_pairs_vec(mu_hat[need], plan.eps_d,
                                             plan.delta_d, c)
            extra = np.maximum(budget - n_r1, 0)
            t0 = time.perf_counter()
            cnt2 = _count_meets(dg, nodes[torch.as_tensor(need,
                                                          device=device)],
                                extra, gen, sc, plan.t_max, chunk, mesh,
                                mesh_axis)
            mu_hat[need] = (cnt1[need] + cnt2) / (extra + n_r1)
            if verbose:
                print(f"  diagonal phase 2: {int(extra.sum())} walk pairs "
                      f"over {len(need)} nodes in "
                      f"{time.perf_counter() - t0:.2f}s")

    d[sampled] = 1.0 - c / deg[sampled] - c * mu_hat
    return d.astype(np.float32)


DEFAULT_D_SHARD = 1 << 14  # nodes per chunked-estimation shard


def estimate_diagonal_chunked(g: csr.Graph, plan: theory.SlingPlan,
                              seed: int = 0,
                              shard: int = DEFAULT_D_SHARD,
                              chunk: int = walks.DEFAULT_CHUNK,
                              dg: walks.DeviceGraph | None = None,
                              verbose: bool = False, *,
                              device=None) -> np.ndarray:
    """Algorithm 4 at scale: :func:`estimate_diagonal` over contiguous
    node shards of ``shard`` nodes on ``device`` (``cuda`` unless
    ``device="cpu"``), shard i drawing from seed ``seed + i``; ``dg`` is
    ``g`` already on that device (made here when None). The positional
    order is the reference's.

    Each shard is the subset mode of a full pass on the whole graph, so
    every node gets the same two-phase Lemma-11 schedule, and the eps_d
    certificate, as in one monolithic pass, while the per-node budgets
    and counts held at once are O(shard)."""
    dev = resolve_device(device)
    if dg is None:
        dg = walks.DeviceGraph.from_graph(g, device=dev)
    d = np.ones(g.n, np.float32)
    for i, s0 in enumerate(range(0, g.n, shard)):
        nodes = np.arange(s0, min(g.n, s0 + shard), dtype=np.int64)
        d = estimate_diagonal(g, plan, seed=seed + i, chunk=chunk, dg=dg,
                              nodes=nodes, d_init=d, device=dev)
        if verbose and i % 8 == 0:
            print(f"  diagonal shard {s0}/{g.n}")
    return d


def exact_diagonal(g: csr.Graph, c: float, iters: int = 50) -> np.ndarray:
    """Ground-truth d_k from the power method (small graphs only)."""
    S = power.all_pairs(g, c=c, iters=iters)
    d = np.ones(g.n, dtype=np.float64)
    for k in range(g.n):
        nbrs = g.in_neighbors(k)
        dk = len(nbrs)
        if dk == 0:
            continue
        sub = S[np.ix_(nbrs, nbrs)]
        d[k] = 1.0 - c / dk - c * (sub.sum() - np.trace(sub)) / (dk * dk)
    return d
