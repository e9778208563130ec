"""Single-source SimRank queries: Alg 6 and its Horner form.

Port of ``repro/core/single_source.py``. The answer sum_l Â^l seed_l
(seed_l[k] = h~^(l)(u, k) * d_k) is computed Horner-stacked,

    acc = seed_L;  for l = L-1 .. 0:  acc = Â prune_tau(acc) + seed_l,

with tau = (sqrt c)^L * theta (:func:`prune_tau`), the smallest of
Alg 6's per-group thresholds.

  * ``single_source_paper`` / ``single_source_horner`` -- host float64
    references (NumPy);
  * ``horner_push`` -- the plain PyTorch push over a batch of rows;
  * ``batched_single_source`` -- (B,) query ids -> (B, n) scores through
    the chosen backend: the Hopper push kernel, one launch, on ``cuda``;
  * ``slab_horner_push`` -- the same push over node slabs, one level at a
    time on every slab (the Hopper slab step on ``cuda``) with the
    frontier all-gathered between levels: the body of the node-sharded
    fan-out (``core/shard_query.py``, ``single_source_batch(mesh=)``)
    and of the pod path ``batched_single_source_sharded``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph import csr
from repro_torch.kernels import horner_push as hpk
from repro_torch.kernels.spmv_ell import SpmmLayout


def prune_tau(plan) -> float:
    """The Horner prune threshold tau = (sqrt c)^l_max * theta."""
    return float(plan.theta * plan.sqrt_c ** plan.l_max)


def _seed_matrix(idx, u: int, g: csr.Graph) -> np.ndarray:
    """(L+1, n) float64: seeds[l, k] = h~^(l)(u,k) * d_k over H(u) as
    ``_host_entries`` gives it (dequantized, step-1/2 entries of a
    reduced row re-materialized, enhanced); duplicate keys add up."""
    n = idx.n
    keys, vals = idx._host_entries(u, g)
    d = idx.d.cpu().numpy()
    seeds = np.zeros((idx.plan.l_max + 1, n), dtype=np.float64)
    np.add.at(seeds, (keys // n, keys % n),
              vals * d[keys % n].astype(np.float64))
    return seeds


def _pull_host(g: csr.Graph, w: np.ndarray, x: np.ndarray) -> np.ndarray:
    out = np.zeros(g.n, dtype=np.float64)
    np.add.at(out, g.edge_dst, x[g.edge_src] * w)
    return out


def single_source_paper(idx, g: csr.Graph, u: int) -> np.ndarray:
    """Faithful Alg 6 on dense n-vectors (host, float64)."""
    sc, theta = idx.plan.sqrt_c, idx.plan.theta
    w = csr.normalized_pull_weights(g, sc).astype(np.float64)
    seeds = _seed_matrix(idx, u, g)
    out = np.zeros(idx.n, dtype=np.float64)
    for l in range(seeds.shape[0]):
        rho = seeds[l]
        if not rho.any():
            continue
        tau = (sc ** l) * theta
        for _ in range(l):
            rho = _pull_host(g, w, np.where(rho > tau, rho, 0.0))
        out += rho
    return out


def single_source_horner(idx, g: csr.Graph, u: int) -> np.ndarray:
    """Horner-stacked push (host, float64)."""
    w = csr.normalized_pull_weights(g, idx.plan.sqrt_c).astype(np.float64)
    seeds = _seed_matrix(idx, u, g)
    L = seeds.shape[0] - 1
    tau = prune_tau(idx.plan)
    acc = seeds[L].copy()
    for l in range(L - 1, -1, -1):
        acc = _pull_host(g, w, np.where(acc > tau, acc, 0.0)) + seeds[l]
    return acc


def horner_push(ku, xu, d, layout, tau: float, *, n: int,
                l_max: int) -> torch.Tensor:
    """Plain PyTorch Horner push: (B, W) packed rows -> (B, n) float32."""
    return hpk.horner_push(ku, xu, d, layout, tau, n=n, l_max=l_max)


def batched_single_source(keys, vals, d, layout, us, tau: float, *,
                          n: int, l_max: int,
                          backend: str = "auto") -> torch.Tensor:
    """Horner push for a batch of sources: keys/vals (N, K) packed
    table, us (B,) int32 or int64 ids -> (B, n) float32 on the table's
    device. ``backend``: "auto" | "kernel" | "plain"
    (``kernels.horner_push``); the kernel reads the rows through ``us``
    itself, in one launch."""
    if n != layout.n:
        raise ValueError(f"n={n} but the layout has n={layout.n}")
    push = hpk.push_for(hpk.resolve_push_backend(backend, keys.device))
    return push(keys, vals, d, us, layout, tau, l_max=l_max)


@dataclasses.dataclass(frozen=True)
class Slab:
    """One shard's part of a push over node slabs: its rows [start,
    start + layout.n) of the node dimension, the CSR of their in-edges
    (``layout``, whose ``in_idx`` are global rows of the gathered
    frontier), and the d it reads at k - ``d_offset``."""
    layout: SpmmLayout
    d: torch.Tensor
    start: int
    d_offset: int

    @property
    def device(self) -> torch.device:
        return self.layout.device


def _gather(outs: list, devices: list, bufs: dict,
            bf16: bool) -> dict:
    """The all-gather of the slabs ``outs`` (n_loc, B): on every distinct
    device, the slabs concatenated in shard order into its buffer,
    copied there ``non_blocking`` on the current stream. ``bf16`` sends
    bfloat16 slabs, read back as float32."""
    got = {}
    for dev in devices:
        parts = [(o.to(torch.bfloat16) if bf16 else o).to(
            dev, non_blocking=True) for o in outs]
        if bf16:
            got[dev] = bufs[dev].copy_(torch.cat(parts))
        else:
            got[dev] = torch.cat(parts, out=bufs[dev])
    return got


def slab_horner_push(ku, xu, slabs: list, tau: float, *, n: int,
                     l_max: int, backend: str | None = "auto",
                     bf16_frontier: bool = False) -> list:
    """The Horner push of the query rows ``ku``/``xu`` (B, W), any order,
    over node slabs that tile the node dimension in order: per slab its
    (n_loc, B) node-major scores on its device.

    The rows are copied to every distinct device and prepared once
    (``kernels.horner_push.slab_rows``). Then level by level, from the
    highest level holding a seed (above it the push is exactly zero)
    to 0, every slab runs one slab step -- the Hopper kernel
    ``horner_push_slab_step`` under the "kernel" backend (the "auto"
    choice on ``cuda``), its plain version under "plain" -- and between
    levels the slabs are all-gathered onto every device, in shard order
    (``bf16_frontier``: as bfloat16, halving the exchange). Slabs may
    share a device."""
    devices = list(dict.fromkeys(sl.device for sl in slabs))
    steps = {dev: hpk.resolve_push_backend(backend, dev) for dev in devices}
    rows = {dev: hpk.slab_rows(ku.to(dev), xu.to(dev), n, l_max)
            for dev in devices}
    top = rows[devices[0]][3]
    B = ku.shape[0]
    outs = [torch.zeros((sl.layout.n, B), dtype=torch.float32,
                        device=sl.device) for sl in slabs]
    if top < 0:
        return outs
    n_rows = sum(sl.layout.n for sl in slabs)
    bufs = [{dev: torch.empty((n_rows, B), dtype=torch.float32, device=dev)
             for dev in devices} for _ in range(2)]
    tau = float(np.float32(tau))
    x = None
    for level in range(top, -1, -1):
        for sl, out in zip(slabs, outs):
            keys, vals, runs, _ = rows[sl.device]
            xs = None if x is None else x[sl.device]
            if steps[sl.device] == "kernel":
                hpk.horner_push_slab_step(
                    xs, sl.layout, keys, vals, runs, sl.d, level, tau, n=n,
                    slab_start=sl.start, d_offset=sl.d_offset, l_max=l_max,
                    out=out)
            else:
                hpk.horner_slab_step_plain(
                    xs, sl.layout, keys, vals, sl.d, level, tau, n=n,
                    slab_start=sl.start, d_offset=sl.d_offset, out=out)
        if level > 0:
            x = _gather(outs, devices, bufs[level & 1], bf16_frontier)
    return outs


def single_source_device(idx, g: csr.Graph, us,
                         backend: str | None = None,
                         device=None) -> np.ndarray:
    """One-shot batched path on ``device`` (``cuda`` unless
    ``device="cpu"``, wherever the index's storage lies): (B,) ids ->
    (B, n) float32 NumPy. The working set is warm after the first call
    (``core/device_state.py``), so repeated calls measure the push, not
    the upload. ``backend``: "auto"/None | "kernel" | "plain"."""
    from repro_torch.core import device_state
    st = device_state.serving_arrays(idx, g, device)
    us = torch.as_tensor(np.asarray(us, np.int64), device=st.d.device)
    return batched_single_source(
        st.keys, st.vals, st.d, st.layout, us, st.tau, n=idx.n,
        l_max=idx.plan.l_max, backend=backend).cpu().numpy()


def single_source_batch(idx, g: csr.Graph, us, mesh=None,
                        axis: str = "data", *, device=None) -> np.ndarray:
    """Multi-source entry point: (B,) ids -> (B, n) float32 NumPy. Without
    ``mesh`` the one-shot path on ``device`` (:func:`single_source_device`);
    with one, node-sharded over ``mesh.shape[axis]``
    (``core/shard_query.py``), the index sharded for this call. A
    serving loop should shard once: a :class:`~repro_torch.core.
    shard_query.ShardedIndex`, or ``QueryEngine`` with
    ``EngineConfig(mesh=...)``."""
    us = np.atleast_1d(np.asarray(us, np.int32))
    if mesh is None:
        return single_source_device(idx, g, us, device=device)
    from repro_torch.core import shard_query
    si = shard_query.shard_index(idx, g, mesh, axis=axis)
    return shard_query.sharded_single_source(si, us)


def _pod_axes(mesh, n: int):
    """The pod path's data axes ("pod", "data" where present and > 1),
    its data positions as coordinate dicts in mesh order, and the slab
    size n // S_model (n must divide)."""
    shape = mesh.shape
    data_axes = tuple(a for a in ("pod", "data")
                      if a in shape and shape[a] > 1)
    ns_m = shape["model"]
    if n % ns_m:
        raise ValueError(f"n={n} does not divide over {ns_m} model shards")
    groups = [dict(zip(data_axes, pos)) for pos in
              np.ndindex(*(shape[a] for a in data_axes))]
    return groups, n // ns_m


def pod_slabs(d, blk_src, blk_dstl, blk_w, n: int, mesh) -> list:
    """The pod path's slabs, built once for many pushes: for each data
    position of ``mesh`` (in mesh order), a list of S_model
    :class:`Slab` on that position's row of "model" devices -- slab j the edges of
    ``blk_*[j]`` (``shard_query.partition_edges``; zero-weight pad slots
    dropped) and ``d`` (n,) whole (d_offset 0)."""
    groups, n_l = _pod_axes(mesh, n)
    edges = [tuple(np.asarray(torch.as_tensor(a[j]).cpu())
                   for a in (blk_src, blk_dstl, blk_w))
             for j in range(mesh.shape["model"])]
    out = []
    for coords in groups:
        slabs = []
        for j, dev in enumerate(mesh.axis_devices("model", **coords)):
            src, dstl, w = edges[j]
            live = w != 0
            slabs.append(Slab(
                layout=SpmmLayout.from_edges(src[live], dstl[live], w[live],
                                             n_l, dev),
                d=d.to(dev), start=j * n_l, d_offset=0))
        out.append(slabs)
    return out


def batched_single_source_sharded(keys, vals, d, blk_src, blk_dstl, blk_w,
                                  us, tau: float, n: int, l_max: int, mesh,
                                  bf16_frontier: bool = False, *,
                                  slabs: list | None = None
                                  ) -> torch.Tensor:
    """The pod-scale push (Alg 6, Horner form) over a mesh with a "model"
    axis and data axes ("pod", "data" where present and > 1): the
    queries ``us`` (B,) split over the data positions, the nodes over
    "model" in slabs of n // S_model (n must divide), ``d`` (n,)
    replicated (d_offset 0), and the frontier all-gathered over "model"
    only between levels (``bf16_frontier``: as bfloat16, which halves the
    exchange and costs ~2^-8 relative a push, to be folded into the
    eps budget by the caller). ``keys``/``vals`` are the full packed
    table, ``blk_*`` (S_model, E) the edges grouped by destination
    shard with slab-local destinations (``shard_query.partition_edges``).
    Each data position's queries run :func:`slab_horner_push` on its row
    of devices. ``slabs``: :func:`pod_slabs` of the same arguments, made
    once by a caller that pushes many batches (``blk_*`` and ``d`` are
    then not read). Returns the (B, n) float32 scores on the mesh's
    first device."""
    groups, _ = _pod_axes(mesh, n)
    if slabs is None:
        slabs = pod_slabs(d, blk_src, blk_dstl, blk_w, n, mesh)
    ids = torch.as_tensor(np.asarray(us), device=keys.device).long()
    if len(ids) % len(groups):
        raise ValueError(f"{len(ids)} queries do not divide over "
                         f"{len(groups)} data positions")
    ku, xu = keys[ids], vals[ids]
    home = mesh.devices.flat[0]
    out = torch.empty((len(ids), n), dtype=torch.float32, device=home)
    for q, group in zip(np.array_split(np.arange(len(ids)), len(groups)),
                        slabs):
        rows = torch.as_tensor(q, device=keys.device)
        outs = slab_horner_push(ku[rows], xu[rows], group, tau, n=n,
                                l_max=l_max, bf16_frontier=bf16_frontier)
        out[torch.as_tensor(q, device=home)] = torch.cat(
            [o.to(home) for o in outs]).t()
    return out
