"""Single-source SimRank queries: Alg 6 and its Horner form.

Port of ``repro/core/single_source.py``. The answer sum_l Â^l seed_l
(seed_l[k] = h~^(l)(u, k) * d_k) is computed Horner-stacked,

    acc = seed_L;  for l = L-1 .. 0:  acc = Â prune_tau(acc) + seed_l,

with tau = (sqrt c)^L * theta (:func:`prune_tau`), the smallest of
Alg 6's per-group thresholds.

  * ``single_source_paper`` / ``single_source_horner`` -- host float64
    references (NumPy); ``single_source_naive`` -- n pair queries
    (Alg 3), the paper's strawman;
  * ``horner_push`` -- the plain PyTorch push over a batch of rows;
  * ``batched_single_source`` -- (B,) query ids -> (B, n) scores through
    the chosen backend: the Hopper push kernel, one launch, on ``cuda``;
  * ``slab_push`` / ``slab_horner_push`` -- the same push over node
    slabs: every slab of one device in one launch of the Hopper kernel
    (``horner_push_slabs``) on ``cuda``, or on a mesh of several devices
    one launch a level a device with the frontier exchanged between
    levels: the body of the node-sharded fan-out
    (``core/shard_query.py``, ``single_source_batch(mesh=)``) and of the
    pod path ``batched_single_source_sharded``.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import csr
from repro_torch.kernels import horner_push as hpk
from repro_torch.kernels.cost import (collective, faking, host_read,
                                     is_fake, worst_case)
from repro_torch.kernels.horner_push import Slab, top_level
from repro_torch.kernels.spmv_ell import SpmmLayout
from repro_torch.launch.sharding import ShardedTensor


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


_workspaces = threading.local()


def _workspace(dev, batch: int, n_rows: int, l_max: int) -> torch.Tensor:
    """The push's scratch on ``dev`` (``hpk.workspace_numel`` words: the
    two node-major frontiers, the seed staging and the level runs),
    cached per (device, B) for the calling thread and grown when a push
    needs more, so a push allocates nothing after the first. A thread
    owns its buffers: the serving frontend's replica workers push from
    several threads, and a push on a mesh keeps its frontier there
    between launches. Under a fake-tensor mode (the dry run) the buffer
    is a new fake one, and the cache is neither read nor written: a
    fake buffer kept there would reach a real launch."""
    need = hpk.workspace_numel(n_rows, batch, l_max)
    if faking():
        return torch.empty(need, dtype=torch.float32, device=dev)
    cache = _workspaces.__dict__.setdefault("bufs", {})
    buf = cache.get((dev, batch))
    if buf is None or buf.numel() < need:
        buf = cache[(dev, batch)] = torch.empty(need, dtype=torch.float32,
                                                device=dev)
    return buf


def release_workspaces() -> None:
    """Drop the calling thread's cached push scratch (``_workspace``): a
    caller done with a large batch gives the device memory back; the
    next push allocates anew."""
    _workspaces.__dict__.pop("bufs", None)


def _tiled_rows(slabs: list) -> int:
    """The rows of the node dimension that ``slabs`` tile, in order."""
    n_rows = 0
    for sl in slabs:
        if sl.start != n_rows:
            raise ValueError(f"slabs must tile the node dimension in "
                             f"order: a slab starts at {sl.start}, not "
                             f"{n_rows}")
        n_rows += sl.layout.n
    return n_rows


def slab_device(slabs: list):
    """The device every slab of ``slabs`` lies on, or None if they lie on
    several: the one place the push's route is decided."""
    dev = slabs[0].device
    return dev if all(sl.device == dev for sl in slabs) else None


def slab_views(full: torch.Tensor, slabs: list) -> list:
    """Per slab its rows of the node-major buffer ``full`` (views)."""
    return [full[sl.start:sl.start + sl.layout.n] for sl in slabs]


def _push_fn(backend: str | None, dev):
    """The slab push a backend runs on ``dev``: the Hopper kernel's
    wrapper under "kernel" (the "auto" choice on ``cuda``; it takes the
    plain version only for CPU tensors), the plain version under
    "plain"."""
    if hpk.resolve_push_backend(backend, dev) == "kernel":
        return hpk.horner_push_slabs
    return hpk.horner_push_slabs_plain


def slab_push(rows, us, slabs: list, tau: float, *, n: int, l_max: int,
              backend: str | None = "auto",
              bf16_frontier: bool = False) -> torch.Tensor:
    """The Horner push of the query ids ``us`` (B,) over node slabs that
    tile the node dimension in order and all lie on one device, in one
    call over every level: one launch of ``horner_push_slabs`` under the
    "kernel" backend (the "auto" choice on ``cuda``), its plain version
    under "plain". ``rows`` is the row source on that device: segments
    (keys, vals, base), packed tables (rows sorted by key, PAD last) of
    the ids [base, base + len(keys)) -- a ShardedIndex's own slabs of
    rows, or one whole table -- read by the kernel through the ids.
    Returns the (n_rows, B) node-major scores of every slab's rows, in
    one buffer allocated for the call (:func:`slab_views` cuts it)."""
    dev = slab_device(slabs)
    if dev is None:
        raise ValueError("slab_push takes slabs on one device; "
                         "slab_horner_push runs a mesh of several")
    n_rows = _tiled_rows(slabs)
    B = us.shape[0]
    full = torch.empty((n_rows, B), dtype=torch.float32, device=dev)
    _push_fn(backend, dev)(
        rows, us, slabs, slab_views(full, slabs), float(np.float32(tau)),
        n=n, l_max=l_max, hi=l_max, lo=0, bf16_frontier=bf16_frontier,
        n_rows=n_rows, workspace=_workspace(dev, B, n_rows, l_max))
    return full


def _exchange(fronts: dict, spans: dict, buf: int, bf16: bool) -> None:
    """Frontier buffer ``buf`` all-gathered over the devices: each
    device's rows (``spans``: its contiguous runs of slab rows) copied
    into every other device's buffer, one copy for each pair of devices
    and each run; as bfloat16 under ``bf16`` (the values are already
    rounded there, so the exchange halves its bytes and loses nothing)."""
    for src, runs in spans.items():
        for lo, hi in runs:
            block = fronts[src][buf, lo:hi]
            if bf16:
                block = block.to(torch.bfloat16)
            for dst, front in fronts.items():
                if dst != src:
                    front[buf, lo:hi].copy_(
                        block, non_blocking=src.type == dst.type == "cuda")


def slab_horner_push(ku, xu, slabs: list, tau: float, *, n: int,
                     l_max: int, backend: str | None = "auto",
                     bf16_frontier: bool = False) -> list:
    """The Horner push of the query rows ``ku``/``xu`` (B, W), each row
    sorted by key with PAD last (as a packed table holds them), over
    node slabs that tile the node dimension in order: per slab its
    (n_loc, B) node-major scores on its device.

    Slabs on one device: :func:`slab_push` of the rows as one segment,
    one launch over every level. Slabs on several devices: the rows are
    copied to every device once, and one host sync finds the highest
    level that holds a seed (above it the push is exactly zero; the
    sync costs less than the launches and copies of the empty levels
    above it, l_max - top of them). Then per level, from there to 0, one
    call a device over all of that device's slabs (``horner_push_slabs``
    under "kernel", the "auto" choice on ``cuda``; its plain version
    under "plain" and on the CPU), each writing its rows into its own
    frontier buffer, and between levels the exchange: each device's
    rows copied into every other device's buffer (``bf16_frontier``:
    every frontier value rounded through bfloat16, and the exchange sent
    as bfloat16, halving it)."""
    B = ku.shape[0]
    dev = slab_device(slabs)
    if dev is not None:
        return slab_views(slab_push(
            [(ku.to(dev), xu.to(dev), 0)], torch.arange(B, device=dev),
            slabs, tau, n=n, l_max=l_max, backend=backend,
            bf16_frontier=bf16_frontier), slabs)
    devices = list(dict.fromkeys(sl.device for sl in slabs))
    n_rows = _tiled_rows(slabs)
    tau = float(np.float32(tau))
    top = top_level(ku, n, l_max)
    mine = {dev: [i for i, sl in enumerate(slabs) if sl.device == dev]
            for dev in devices}
    with collective("all-reduce"):     # the rest of the psum row fetch
        rows = {dev: [(ku.to(dev), xu.to(dev), 0)] for dev in devices}
    ids = {dev: torch.arange(B, device=dev) for dev in devices}
    ws = {dev: _workspace(dev, B, n_rows, l_max) for dev in devices}
    fronts = {dev: hpk.frontier_view(ws[dev], n_rows, B) for dev in devices}
    spans = {}
    for dev, idx in mine.items():
        runs = []
        for i in idx:
            lo, hi = slabs[i].start, slabs[i].start + slabs[i].layout.n
            if runs and runs[-1][1] == lo:
                runs[-1] = (runs[-1][0], hi)
            else:
                runs.append((lo, hi))
        spans[dev] = runs
    outs = [torch.empty((sl.layout.n, B), dtype=torch.float32,
                        device=sl.device) for sl in slabs]
    for level in range(max(top, 0), -1, -1):
        for dev, idx in mine.items():
            _push_fn(backend, dev)(
                rows[dev], ids[dev], [slabs[i] for i in idx],
                [outs[i] for i in idx], tau, n=n, l_max=l_max, hi=level,
                lo=level, bf16_frontier=bf16_frontier, n_rows=n_rows,
                workspace=ws[dev])
        if level > 0:
            with collective("all-gather"):
                _exchange(fronts, spans, level & 1, bf16_frontier)
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


def single_source_naive(idx, g: csr.Graph, u: int, *,
                        device=None) -> np.ndarray:
    """n invocations of Alg 3 (the paper's strawman; Figure 2): (n,)
    float64 NumPy. On ``cuda`` (the default) the n pairs (u, v) go
    through the pair join kernel (``hp_join``) in batches of the
    engine's pair batch; on the CPU through ``query_pair_host``, as in
    the reference."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return np.array([idx.query_pair_host(u, v, g) for v in range(idx.n)])
    from repro_torch.kernels.hp_join import fold_sqrt_d, hp_join
    from repro_torch.serve.engine import EngineConfig
    idx.refuse_reduced("single_source_naive")
    keys, folded = fold_sqrt_d(idx, device=dev)
    B = EngineConfig().pair_batch
    us = torch.full((B,), u, dtype=torch.int32, device=dev)
    out = torch.empty(idx.n, dtype=torch.float32, device=dev)
    for lo in range(0, idx.n, B):
        vs = torch.arange(lo, min(lo + B, idx.n), dtype=torch.int32,
                          device=dev)
        out[lo:lo + B] = hp_join(keys, folded, us[:len(vs)], vs)
    return out.cpu().numpy().astype(np.float64)


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
    dropped) and ``d`` (n,) whole (d_offset 0). A ``blk_*`` placed over
    "model" (a ``ShardedTensor``, as the cell places it) gives each
    slab the block that lies on its device. Fake blocks (the dry run's)
    hold no edges: each slab is taken with every slot of its block live,
    its layout's arrays empty on its device."""
    groups, n_l = _pod_axes(mesh, n)
    arrays = (blk_src, blk_dstl, blk_w)

    def block(a, j, coords):
        if isinstance(a, ShardedTensor):
            pos = mesh.axes_positions(("model",), **coords)[j]
            return a.pieces[pos][0]
        return torch.as_tensor(a)[j]

    if is_fake(*(block(a, 0, groups[0]) for a in arrays)):
        worst_case("pod_slabs: every slot of a slab's edge block live")
        host_read("_to_copy")
        e_max = block(blk_src, 0, groups[0]).shape[0]
        return [[_fake_slab(n_l, e_max, d, j, dev) for j, dev in
                 enumerate(mesh.axis_devices("model", **coords))]
                for coords in groups]
    edges = [tuple(np.asarray(block(a, j, groups[0]).cpu())
                   for a in arrays)
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


def _fake_slab(n_l: int, e: int, d, j: int, dev) -> Slab:
    """Slab j of ``n_l`` rows under a fake-tensor mode: its layout's
    arrays empty on ``dev``, every one of its ``e`` edge slots live."""
    def empty(numel, dtype=torch.int32):
        return torch.empty((numel,), dtype=dtype, device=dev)
    return Slab(layout=SpmmLayout(n=n_l, in_ptr=empty(n_l + 1),
                                  in_idx=empty(e), w=empty(e, torch.float32),
                                  heavy=empty(0), light=empty(n_l)),
                d=d.to(dev), start=j * n_l, d_offset=0)


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
    Each data position's queries run on its row of devices: where the
    row is one device that holds the table, :func:`slab_push` with the
    table as the row source (one launch a position on ``cuda``), else
    :func:`slab_horner_push` on the rows fetched for them. ``slabs``:
    :func:`pod_slabs` of the same arguments, made once by a caller that
    pushes many batches (``blk_*`` and ``d`` are then not read). Returns
    the (B, n) float32 scores on the mesh's first device."""
    groups, _ = _pod_axes(mesh, n)
    if slabs is None:
        slabs = pod_slabs(d, blk_src, blk_dstl, blk_w, n, mesh)
    fake = is_fake(us)
    if not fake:
        us = np.asarray(us)
    if len(us) % len(groups):
        raise ValueError(f"{len(us)} queries do not divide over "
                         f"{len(groups)} data positions")
    home = mesh.devices.flat[0]
    out = torch.empty((len(us), n), dtype=torch.float32, device=home)
    for q, group in zip(np.array_split(np.arange(len(us)), len(groups)),
                        slabs):
        if len(q) == 0:
            continue
        ids = us[q[0]:q[-1] + 1].to(keys.device, torch.int64) if fake \
            else torch.as_tensor(us[q].astype(np.int64), device=keys.device)
        if slab_device(group) == keys.device:
            full = slab_push([(keys, vals, 0)], ids, group, tau, n=n,
                             l_max=l_max, bf16_frontier=bf16_frontier)
        else:
            full = torch.cat([o.to(home) for o in slab_horner_push(
                keys[ids], vals[ids], group, tau, n=n, l_max=l_max,
                bf16_frontier=bf16_frontier)])
        out[q[0]:q[-1] + 1] = full.t()
    return out
