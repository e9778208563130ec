"""Device-streamed bulk similarity join: the all-sources top-k sweep.

Port of ``repro/join/sweep.py``. The online engine
answers one micro-batch at a time; feature consumers want *bulk*
answers: "for every node (or a large node set), its k most SimRank-
similar nodes", materialized once and read as a static kNN graph. The
sweep

  * partitions the source set into **fixed-shape tiles** (``tile``
    sources, the last tile padded by repeating a real source), so a
    whole sweep dispatches exactly one shape, ``(tile, kq, backend)``
    -- the port's counterpart of the reference's one compiled program
    (:func:`compile_count`);
  * streams every tile through the Horner push (``core/topk.
    batched_topk`` over ``device_state.serving_arrays``: on ``cuda``
    one ``horner_push`` launch a tile) and a stable top-k on the
    device -- only the (tile, kq) values and ids go to the host, never
    a tile's (tile, n) score slab. With ``JoinConfig(mesh=...)`` the
    index is sharded once up front and every tile goes through the
    node-sharded fan-out (``core/shard_query.sharded_topk``);
  * accumulates tile results in a host buffer with **tile-granular
    checkpoints** (atomic-rename npz, fingerprinted against the sweep
    configuration), so a long join survives preemption and a resumed
    sweep is bit-identical to an uninterrupted one;
  * finalizes into a versioned :class:`~repro_torch.join.artifact.
    KnnGraph` carrying the plan's eps certificate and the index epoch
    (the staleness handshake with ``QueryEngine.knn``).

Threshold variant: ``JoinConfig(tau=...)`` keeps every neighbor with
``sim >= tau`` instead of a fixed k. The device program is the same
fixed-shape top-k with k = ``cap`` candidates a source; the host keeps
the prefix above tau. When a source's cap-th candidate still scores
>= tau the row may be incomplete and is flagged in
``KnnGraph.truncated``, never silently dropped.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.join.artifact import CKPT_FORMAT_VERSION, KnnGraph
from repro_torch.kernels.horner_push import resolve_push_backend
from repro_torch.launch.mesh import mesh_device

_shapes: set = set()   # every (tile, kq, backend) dispatched in the process


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Sweep configuration (all static: part of the dispatch shape and
    the checkpoint fingerprint)."""
    k: int = 16               # neighbors per source (top-k mode)
    tau: float | None = None  # sim >= tau threshold mode when set
    cap: int = 256            # device candidates/source in threshold mode
    tile: int = 64            # fixed source-tile shape
    exclude_self: bool = False  # drop s(u, u) from u's row
    mesh: object = None       # serving mesh: nodes shard over mesh_axis
    mesh_axis: str = "data"
    checkpoint_path: str | None = None  # tile-granular resume state
    checkpoint_every: int = 8           # tiles between checkpoint writes
    # Horner-push backend of the tile program ("auto" | "plain" |
    # "kernel", kernels.horner_push); part of the checkpoint fingerprint:
    # the two sum in different float32 orders, so their tiles are not
    # interchangeable bit for bit
    push_backend: str | None = None


def compile_count() -> int:
    """Distinct (tile, kq, backend) tile-program shapes the sweeps of
    this process dispatched, with ("mesh", shards) for a sharded sweep:
    a sweep adds exactly one, and a sweep of the same configuration adds
    none (the fixed-shape gate; the reference's name)."""
    return len(_shapes)


def _mesh_shards(cfg: JoinConfig) -> int:
    return 1 if cfg.mesh is None else int(cfg.mesh.shape[cfg.mesh_axis])


def _kq(cfg: JoinConfig, n: int) -> int:
    """Device candidates fetched per source: k (or cap), plus one slot
    when the self entry is to be dropped on the host, clamped to n."""
    base = cfg.cap if cfg.tau is not None else cfg.k
    return max(1, min(n, int(base) + (1 if cfg.exclude_self else 0)))


def _fingerprint(idx, g, sources: np.ndarray, cfg: JoinConfig, kq: int,
                 backend: str, device: torch.device) -> dict:
    """Everything a resumed sweep must agree on for its cached tiles to
    be interchangeable with freshly computed ones (bit-stability): the
    graph/index identity, the tile geometry, the mesh layout, the
    resolved push backend and the device type (the plain push sums in
    another order on the CPU than on the card). The reference records
    ``"lax"`` or ``"pallas"``, so its checkpoints are refused here,
    never resumed."""
    return {
        "n": int(idx.n), "m": int(g.m), "epoch": int(idx.epoch),
        "eps": float(idx.plan.eps), "c": float(idx.plan.c),
        "theta": float(idx.plan.theta), "l_max": int(idx.plan.l_max),
        "mode": "threshold" if cfg.tau is not None else "topk",
        "k": int(cfg.k),
        "tau": None if cfg.tau is None else float(cfg.tau),
        "cap": int(cfg.cap), "tile": int(cfg.tile), "kq": int(kq),
        "exclude_self": bool(cfg.exclude_self),
        "mesh_shards": _mesh_shards(cfg),
        "n_sources": int(len(sources)),
        "push_backend": backend,
        "device": device.type,
    }


# ----------------------------------------------------------------------
# checkpoints (tile-granular resume; format in INDEX_FORMAT.md)
# ----------------------------------------------------------------------
def _save_checkpoint(path: str, fp: dict, sources: np.ndarray,
                     tiles_done: int, vals: np.ndarray,
                     ids: np.ndarray) -> None:
    """Atomic write (tmp + rename): a preemption mid-write leaves the
    previous checkpoint intact, never a torn file. Only the completed
    ``tiles_done * tile`` row prefix is written."""
    done = tiles_done * fp["tile"]
    meta = dict(fp)
    meta["_format_version"] = CKPT_FORMAT_VERSION
    meta["tiles_done"] = int(tiles_done)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, meta=json.dumps(meta), sources=sources,  # slinglint: disable=banned-api -- the atomic writer itself (tmp + os.replace below)
                            vals=vals[:done], ids=ids[:done])
    os.replace(tmp, path)


def _load_checkpoint(path: str, fp: dict, sources: np.ndarray):
    """(tiles_done, vals_prefix, ids_prefix), or None when no checkpoint
    exists. A checkpoint whose fingerprint (or source set) differs from
    the running sweep's is refused, never partly reused: mixing tiles of
    two sweep configurations would corrupt the artifact silently."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        ck_sources = z["sources"].astype(np.int32)
        vals, ids = z["vals"].astype(np.float32), z["ids"].astype(np.int32)
    version = meta.pop("_format_version", 0)
    if version > CKPT_FORMAT_VERSION:
        raise ValueError(
            f"join checkpoint is format v{version}, this build reads "
            f"<= v{CKPT_FORMAT_VERSION} (see INDEX_FORMAT.md)")
    tiles_done = int(meta.pop("tiles_done"))
    if meta != fp:
        diff = {k for k in set(meta) | set(fp) if meta.get(k) != fp.get(k)}
        raise ValueError(
            "join checkpoint fingerprint mismatch on "
            f"{sorted(diff)}: the checkpoint was written by a different "
            "sweep (graph, index epoch, tile geometry, mesh layout, push "
            "backend or device changed); delete it or fix the "
            "configuration")
    if not np.array_equal(ck_sources, sources):
        raise ValueError("join checkpoint source set differs from the "
                         "running sweep; refusing to resume")
    if vals.shape != (tiles_done * fp["tile"], fp["kq"]) \
            or ids.shape != vals.shape:
        raise ValueError("join checkpoint arrays do not cover its "
                         f"claimed {tiles_done} tiles")
    return tiles_done, vals, ids


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------
def _tile_runner(idx, g, cfg: JoinConfig, kq: int, backend: str,
                 device: torch.device):
    """The one tile program of a sweep: the Horner push of ``tile``
    sources and a stable top-k of kq on ``device``, or, with a mesh, the
    node-sharded fan-out over an index sharded once here; returns
    ``run_tile(us) -> (vals (tile, kq), ids (tile, kq))`` as NumPy."""
    from repro_torch.core import device_state, shard_query
    from repro_torch.core.topk import batched_topk
    shape = (int(cfg.tile), int(kq), backend)
    if cfg.mesh is not None:
        shape += ("mesh", _mesh_shards(cfg))
        si = shard_query.shard_index(idx, g, cfg.mesh, axis=cfg.mesh_axis)

        def run_tile(us: np.ndarray):
            _shapes.add(shape)
            return shard_query.sharded_topk(si, us, kq, backend=backend)
        return run_tile
    st = device_state.serving_arrays(idx, g, device)

    def run_tile(us: np.ndarray):
        _shapes.add(shape)
        v, i = batched_topk(
            st.keys, st.vals, st.d, st.layout,
            torch.as_tensor(us, dtype=torch.int64, device=device),
            st.tau, n=idx.n, l_max=idx.plan.l_max, k=kq, backend=backend)
        return v.cpu().numpy(), i.cpu().numpy()
    return run_tile


def run_join(idx, g, sources=None, config: JoinConfig | None = None,
             *, stop_after_tiles: int | None = None,
             device=None) -> KnnGraph | None:
    """Sweep ``sources`` (default: all n nodes) through the join on
    ``device`` (``cuda`` unless ``device="cpu"``; with ``config.mesh``
    the mesh's first device, which ``device`` must be if given) and
    return the materialized :class:`KnnGraph`.

    With ``config.checkpoint_path`` the sweep saves tile-granular
    progress every ``checkpoint_every`` tiles and resumes from an
    existing compatible checkpoint; ``stop_after_tiles`` aborts after
    that many *newly computed* tiles, after forcing a checkpoint write,
    and returns None (a simulated preemption). A resumed sweep replays
    only the missing tiles through the same tile program, so its
    artifact is bit-identical to an uninterrupted sweep's.
    """
    cfg = config or JoinConfig()
    dev = (resolve_device(device) if cfg.mesh is None
           else mesh_device(cfg.mesh, cfg.mesh_axis, device))
    n = idx.n
    if sources is None:
        srcs = np.arange(n, dtype=np.int32)
    else:
        srcs = np.asarray(sources, np.int32).ravel()
        if len(srcs) == 0:
            raise ValueError("empty source set")
        if len(np.unique(srcs)) != len(srcs):
            raise ValueError("join sources must be unique (duplicate "
                             "rows would shadow each other in the "
                             "artifact's row lookup)")
        if srcs.min() < 0 or srcs.max() >= n:
            raise ValueError(f"source id outside [0, {n})")
    backend = resolve_push_backend(cfg.push_backend, dev)
    kq = _kq(cfg, n)
    S = len(srcs)
    n_tiles = -(-S // cfg.tile)
    S_pad = n_tiles * cfg.tile
    # pad the ragged tail by repeating a real source: identical math,
    # results discarded -- the engine's batches do the same
    srcs_pad = np.concatenate(
        [srcs, np.full(S_pad - S, srcs[0], np.int32)])

    fp = _fingerprint(idx, g, srcs, cfg, kq, backend, dev)
    vals = np.zeros((S_pad, kq), np.float32)
    ids = np.zeros((S_pad, kq), np.int32)
    start_tile = 0
    if cfg.checkpoint_path is not None:
        ck = _load_checkpoint(cfg.checkpoint_path, fp, srcs)
        if ck is not None:
            start_tile, done_v, done_i = ck
            vals[:len(done_v)] = done_v
            ids[:len(done_i)] = done_i

    run_tile = _tile_runner(idx, g, cfg, kq, backend, dev)
    done_this_run = 0
    for t in range(start_tile, n_tiles):
        lo = t * cfg.tile
        v, i = run_tile(srcs_pad[lo:lo + cfg.tile])
        vals[lo:lo + cfg.tile] = v
        ids[lo:lo + cfg.tile] = i
        done_this_run += 1
        finished = t + 1 == n_tiles
        if cfg.checkpoint_path is not None and not finished and (
                done_this_run % cfg.checkpoint_every == 0
                or done_this_run == stop_after_tiles):
            _save_checkpoint(cfg.checkpoint_path, fp, srcs, t + 1,
                             vals, ids)
        if done_this_run == stop_after_tiles and not finished:
            return None

    knn = _finalize(idx, srcs, vals[:S], ids[:S], cfg, kq)
    if cfg.checkpoint_path is not None \
            and os.path.exists(cfg.checkpoint_path):
        os.remove(cfg.checkpoint_path)  # complete: the artifact is the state
    return knn


def _finalize(idx, srcs: np.ndarray, vals: np.ndarray, ids: np.ndarray,
              cfg: JoinConfig, kq: int) -> KnnGraph:
    """Host reduction of the (S, kq) candidate block to the CSR rows:
    drop the self entry (exclude_self), cut at tau (threshold mode),
    flag possibly-incomplete threshold rows. Deterministic array
    bookkeeping, so artifact equality reduces to tile-result equality."""
    S = len(srcs)
    threshold = cfg.tau is not None
    truncated = np.zeros(S, bool) if threshold else None
    budget = cfg.cap if threshold else cfg.k
    if not threshold and not cfg.exclude_self:
        # plain top-k: every row is the full kq-candidate block, so the
        # CSR is a reshape with no per-source host loop
        nbr_ids, nbr_scores = ids.ravel(), vals.ravel()
        indptr = np.arange(S + 1, dtype=np.int64) * kq
    else:
        row_ids: list[np.ndarray] = []
        row_scores: list[np.ndarray] = []
        lengths = np.empty(S, np.int64)
        for i in range(S):
            r_ids, r_sc = ids[i], vals[i]
            if cfg.exclude_self:
                keep = r_ids != srcs[i]
                if keep.all():
                    # self fell below the kq-th candidate (only under
                    # heavy ties): drop the last slot so the row stays
                    # <= k entries
                    keep[-1] = False
                r_ids, r_sc = r_ids[keep], r_sc[keep]
            r_ids, r_sc = r_ids[:budget], r_sc[:budget]
            if threshold:
                # candidates are sorted descending: the cut is a prefix
                cut = int((r_sc >= cfg.tau).sum())
                if cut == len(r_sc) and kq < idx.n and len(r_sc) > 0:
                    truncated[i] = True  # cap-th candidate still >= tau
                r_ids, r_sc = r_ids[:cut], r_sc[:cut]
            row_ids.append(r_ids)
            row_scores.append(r_sc)
            lengths[i] = len(r_ids)
        indptr = np.zeros(S + 1, np.int64)
        np.cumsum(lengths, out=indptr[1:])
        nbr_ids = np.concatenate(row_ids)
        nbr_scores = np.concatenate(row_scores)
    return KnnGraph(
        n=idx.n, mode="threshold" if threshold else "topk",
        k=int(budget), tau=cfg.tau, exclude_self=cfg.exclude_self,
        tile=cfg.tile, eps=float(idx.plan.eps), c=float(idx.plan.c),
        theta=float(idx.plan.theta), l_max=int(idx.plan.l_max),
        epoch=int(idx.epoch), mesh_shards=_mesh_shards(cfg), sources=srcs,
        indptr=indptr, nbr_ids=nbr_ids.astype(np.int32),
        nbr_scores=nbr_scores.astype(np.float32), truncated=truncated)
