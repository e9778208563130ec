"""Unified SimRank query engine on one device: pairs, single-source and
top-k from a built :class:`~repro_torch.core.index.SlingIndex`.

Port of ``repro/serve/engine.py``. The dispatch contract is the
reference's:

  * **fixed batch shapes** -- requests are chunked and padded to
    ``pair_batch`` / ``source_batch``; the packed table is padded to a
    capacity bucket of its width. Eager PyTorch compiles nothing, so
    the fixed set of dispatch shapes (``stats()["unique_shapes"]``,
    which must not grow after ``warmup``; each shape names the width
    bucket) is the port's counterpart of the reference's compile-once
    rule;
  * **epoch-based hot-swap** -- ``swap_index`` installs an incrementally
    repaired index (``core/update.py``) into the same buckets and drops
    the cache entries the update may have changed; a swap that fits
    adds no dispatch shape, and a bucket growth (a width past the
    bucket, or a changed ``l_max``) is counted in
    ``stats()["swap_recompiles"]``. The engine holds copies of the
    index's tensors, so an in-place ``update_index`` does not reach it
    before the swap;
  * **k-bucketing** -- top-k rounds k up to a configured bucket (or n
    past the largest) and slices the answer;
  * **LRU score cache** keyed by (type, node(s), bucket), with the
    symmetric pair key (s(u,v) = s(v,u));
  * **backends** -- ``pair_backend``: "kernel" (the Hopper ``hp_join``
    over sqrt(d)-folded rows) or "join" (the searchsorted join);
    ``push_backend``: "kernel" (the Hopper Horner step) or "plain".
    "auto" resolves by the engine's device: the kernels on ``cuda``,
    the plain versions on ``cpu``;
  * **artifacts** -- ``from_index_file`` serves a saved index; a mapped
    (host-resident) or quantized index is uploaded as stored and
    dequantized on the engine's device at install and at a swap. A
    space-reduced index is refused: its packed rows lack the step-1/2
    entries that only ``SlingIndex.query_pair_host(u, v, g)``
    re-materializes;
  * **node-sharded serving** -- with ``EngineConfig(mesh=...)`` the
    index is cut into node slabs over ``mesh.shape[mesh_axis]``
    (``core/shard_query.py``) and single-source and top-k fan out over
    them; the single-device edge layout is not allocated. Pairs stay on
    the mesh's first device, which is the engine's device: a pair reads
    two packed rows, not the graph. A swap re-shards with the previous
    caps as floors, so one that fits adds no shape;
  * **materialized kNN lookups** -- ``attach_knn`` installs a bulk-join
    artifact (:class:`~repro_torch.join.KnnGraph`) and ``knn(u)``
    answers from it on the host, refused once a swap has moved the
    served epoch past the artifact's.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import hp_index, shard_query
from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.core.index import SlingIndex, _pair_query_batch
from repro_torch.core.single_source import (batched_single_source,
                                            prune_tau)
from repro_torch.core.topk import batched_topk
from repro_torch.device import resolve_device, synchronize
from repro_torch.graph import csr
from repro_torch.kernels.hp_join import fold_sqrt_d_arrays, hp_join
from repro_torch.kernels.horner_push import resolve_push_backend
from repro_torch.kernels.spmv_ell import SpmmLayout
from repro_torch.launch.mesh import mesh_device

PAIR_BACKENDS = ("auto", "join", "kernel")


class _LRU:
    """Minimal LRU map with total and per-query-kind hit/miss counts
    (keys lead with the kind tag: "pair" / "src" / "topk")."""

    def __init__(self, cap: int):
        self.cap = cap
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hits_by_kind: dict[str, int] = {}
        self.misses_by_kind: dict[str, int] = {}

    def get(self, key):
        kind = key[0]
        if self.cap > 0 and key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            self.hits_by_kind[kind] = self.hits_by_kind.get(kind, 0) + 1
            return self._d[key]
        self.misses += 1
        self.misses_by_kind[kind] = self.misses_by_kind.get(kind, 0) + 1
        return None

    def put(self, key, value) -> None:
        if self.cap <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    pair_batch: int = 256        # fixed pair-path batch shape
    source_batch: int = 8        # fixed single-source/top-k batch shape
    k_buckets: tuple[int, ...] = (1, 16, 64, 256)
    cache_size: int = 256        # LRU entries across all query types
    pair_backend: str = "auto"   # "auto" | "join" | "kernel"
    push_backend: str = "auto"   # "auto" | "plain" | "kernel"
    # hot-swap shape stability: the packed table is padded to a capacity
    # bucket with this headroom, so a repaired index whose packed width
    # grew a little swaps in under the same dispatch shapes; a swap
    # grows the bucket only when the new index overflows it (counted in
    # stats())
    swap_headroom: float = 1.25
    cap_quantum: int = 64        # buckets are multiples of this
    # node-sharded serving: a launch.mesh.Mesh whose ``mesh_axis`` cuts
    # the index into node slabs; single-source and top-k fan out over
    # them (core/shard_query.py). None = one device. Pairs stay on the
    # mesh's first device.
    mesh: object = None
    mesh_axis: str = "data"
    # serve an index whose diagonal carries no eps_d certificate; off by
    # default because the Theorem-1 bound then does not hold
    allow_uncertified: bool = False


class QueryEngine:
    """Front-end over a SlingIndex for all three SimRank query types,
    on ``device`` (``cuda`` unless ``device="cpu"``)."""

    def __init__(self, index: SlingIndex, g: csr.Graph,
                 config: EngineConfig | None = None, device=None):
        self.cfg = config or EngineConfig()
        index.refuse_reduced("QueryEngine")
        if index.uncertified_d and not self.cfg.allow_uncertified:
            raise ValueError(
                "index diagonal is uncertified: the Theorem-1 eps bound "
                "does not hold. Rebuild with a certified diagonal, or "
                "pass EngineConfig(allow_uncertified=True) to serve it "
                "anyway")
        if index.n < 1:
            raise ValueError("cannot serve an empty index")
        self.device = (resolve_device(device) if self.cfg.mesh is None
                       else mesh_device(self.cfg.mesh, self.cfg.mesh_axis,
                                        device))
        if self.cfg.pair_backend not in PAIR_BACKENDS:
            raise ValueError(f"pair backend {self.cfg.pair_backend!r} not "
                             f"in {PAIR_BACKENDS}")
        self._pair_backend = self.cfg.pair_backend
        if self._pair_backend == "auto":
            self._pair_backend = ("kernel" if self.device.type == "cuda"
                                  else "join")
        self._push_backend = resolve_push_backend(self.cfg.push_backend,
                                                  self.device)
        self._cache = _LRU(self.cfg.cache_size)
        self._shapes: set = set()
        # warmup dispatches prime shapes but are not traffic
        self._counts = {"pair": 0, "source": 0, "topk": 0, "knn": 0,
                        "knn_stale_rejects": 0,
                        "batches": 0, "pad_slots": 0,
                        "warmup_batches": 0, "warmup_pad_slots": 0}
        self._knn = None          # attached KnnGraph artifact (if any)
        self._in_warmup = False
        self._swaps = {"swaps": 0, "last_swap_ms": 0.0,
                       "swap_recompiles": 0, "invalidated": 0}
        self._width_cap = self._bucket(index.hp.width)
        self._sharded = None         # the ShardedIndex under a mesh
        self._install(index, g)

    # ------------------------------------------------------------------
    def _bucket(self, x: int) -> int:
        return hp_index.capacity_bucket(x, self.cfg.cap_quantum,
                                        self.cfg.swap_headroom)

    def _padded(self, t: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((t.shape[0], self._width_cap), fill,
                         dtype=t.dtype, device=self.device)
        out[:, :t.shape[1]] = t.to(self.device)
        return out

    def _install(self, index: SlingIndex, g: csr.Graph) -> None:
        """Copy ``index``/``g`` to the device with the packed table
        padded to the width bucket (PAD keys, zero values: inert in every
        path). Every tensor is the engine's own copy, never the index's,
        so an in-place update of the index reaches the engine only
        through ``swap_index``. Wherever the index's storage lies (a
        mapped artifact is host memory), it is uploaded as stored --
        int16 or bf16 codes when quantized -- and dequantized on the
        engine's device (``vals_f32``)."""
        self._keys = self._padded(index.hp.keys, INT32_PAD_KEY)
        self._vals = self._padded(index.vals_f32(device=self.device), 0.0)
        self._d = index.d.to(self.device, torch.float32, copy=True)
        self._layout = None
        if self.cfg.mesh is None:
            self._layout = SpmmLayout.pull(g, index.plan.sqrt_c,
                                           self.device)
        else:
            # the width bucket as the floor, so a swap that fits keeps
            # every dispatch shape
            self._sharded = shard_query.shard_index(
                index, g, self.cfg.mesh, axis=self.cfg.mesh_axis,
                width_cap=self._width_cap,
                edge_cap=None if self._sharded is None
                else self._sharded.edge_cap,
                cap_quantum=self.cfg.cap_quantum,
                headroom=self.cfg.swap_headroom)
        self._tau = prune_tau(index.plan)
        self._folded_vals = None
        if self._pair_backend == "kernel":
            self._folded_vals = fold_sqrt_d_arrays(self._keys, self._vals,
                                                   self._d)
        self.index = index
        self.g = g

    def swap_index(self, index: SlingIndex, g: csr.Graph,
                   affected=None) -> dict:
        """Epoch-based hot-swap: install a repaired index (and its graph)
        into the engine's buckets and drop the cache entries it may have
        changed.

        A swap that keeps ``n`` and ``l_max`` and fits the width bucket
        is a device copy plus cache invalidation: no dispatch shape
        changes. A width past the bucket grows it, and a changed
        ``l_max`` changes the push's step count; each is counted in
        ``stats()["swap_recompiles"]``. Refused: a changed ``n`` (a new
        engine's job) and an uncertified diagonal without
        ``allow_uncertified``. ``affected`` (``UpdateReport.affected``)
        restricts invalidation as :meth:`invalidate` says; ``None``
        drops the whole cache. Returns swap metrics (also in
        ``stats()``)."""
        t0 = time.perf_counter()
        index.refuse_reduced("swap_index")
        if index.uncertified_d and not self.cfg.allow_uncertified:
            raise ValueError(
                "refusing to hot-swap in an uncertified-diagonal index; "
                "pass EngineConfig(allow_uncertified=True)")
        if index.n != self.index.n:
            raise ValueError("hot-swap requires a fixed node set "
                             f"({index.n} != {self.index.n}); a changed n "
                             "is a rebuild and a new engine")
        recompiles = 0
        if index.plan.l_max != self.index.plan.l_max:
            recompiles += 1
        if index.hp.width > self._width_cap:
            self._width_cap = self._bucket(index.hp.width)
            recompiles += 1
        self._install(index, g)
        dropped = self.invalidate(affected)
        synchronize(self.device)
        ms = 1e3 * (time.perf_counter() - t0)
        self._swaps["swaps"] += 1
        self._swaps["last_swap_ms"] = ms
        self._swaps["swap_recompiles"] += recompiles
        return {"swap_ms": ms, "recompiles": recompiles,
                "cache_dropped": dropped, "epoch": index.epoch}

    def invalidate(self, nodes=None) -> int:
        """Drop cached scores whose value may depend on ``nodes``
        (``None`` drops everything). A single-source or top-k entry holds
        scores for all n targets, so any non-empty hot set drops every
        one of them. A pair entry reads its endpoints' rows and d at its
        meeting nodes, so it is dropped when an endpoint or a meeting
        node is hot. Returns the count dropped."""
        cache = self._cache._d
        if nodes is None:
            dropped = len(cache)
            cache.clear()
        else:
            hot = set(np.asarray(nodes).ravel().tolist())
            stale = []
            if hot:
                cold = [k for k in cache if k[0] == "pair"
                        and k[1] not in hot and k[2] not in hot]
                rows = self._host_rows({x for k in cold for x in k[1:]})
                stale = [k for k in cache if k[0] != "pair"
                         or k[1] in hot or k[2] in hot]
                stale += [k for k in cold
                          if self._pair_meets_hot(k[1], k[2], hot, rows)]
            for k in stale:
                del cache[k]
            dropped = len(stale)
        self._swaps["invalidated"] += dropped
        return dropped

    def _host_rows(self, nodes) -> dict:
        """{node: its live packed keys} of the current index, fetched
        from the device in one copy."""
        if not nodes:
            return {}
        ids = sorted(nodes)
        hp = self.index.hp
        t = torch.as_tensor(ids, device=hp.keys.device)
        keys, counts = hp.keys[t].cpu().numpy(), hp.counts[t].cpu().numpy()
        return {u: keys[i, :counts[i]] for i, u in enumerate(ids)}

    def _pair_meets_hot(self, u: int, v: int, hot: set, rows: dict) -> bool:
        """Does the cached pair (u, v) read d at a hot meeting node?
        Checked against the current index's rows (``rows``, from
        :meth:`_host_rows`): the endpoints are not hot, so their rows
        were not repaired and the key intersection is the one the cached
        value was computed from."""
        meet = np.intersect1d(rows[u], rows[v], assume_unique=True)
        return bool(len(meet)) and not hot.isdisjoint(
            (meet.astype(np.int64) % self.index.n).tolist())

    # ------------------------------------------------------------------
    def _k_bucket(self, k: int) -> int:
        """Smallest configured bucket >= k, clamped to n; k past the
        largest bucket gets the full-ranking n bucket."""
        k = max(1, min(int(k), self.index.n))
        fits = [b for b in self.cfg.k_buckets if b >= k]
        return min(min(fits), self.index.n) if fits else self.index.n

    def _record(self, kind: str, shape) -> None:
        key = "warmup_batches" if self._in_warmup else "batches"
        self._counts[key] += 1
        shape = (kind,) + tuple(shape)
        if self._sharded is not None and kind != "pair":
            shape += ("mesh", self._sharded.n_shards)
        self._shapes.add(shape)

    def _count_pad(self, pad: int) -> None:
        key = "warmup_pad_slots" if self._in_warmup else "pad_slots"
        self._counts[key] += pad

    def _ids(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int32, device=self.device)

    def _dispatch_pairs(self, us: np.ndarray, vs: np.ndarray) -> np.ndarray:
        B = self.cfg.pair_batch
        pad = (-len(us)) % B
        self._count_pad(pad)
        us_p = np.concatenate([us, np.zeros(pad, np.int32)]).astype(np.int32)
        vs_p = np.concatenate([vs, np.zeros(pad, np.int32)]).astype(np.int32)
        out = np.empty(len(us_p), np.float32)
        for lo in range(0, len(us_p), B):
            u_b, v_b = self._ids(us_p[lo:lo + B]), self._ids(vs_p[lo:lo + B])
            self._record("pair", (B, self._pair_backend,
                                  self._width_cap))
            if self._pair_backend == "kernel":
                chunk = hp_join(self._keys, self._folded_vals,
                                u_b, v_b)
            else:
                chunk = _pair_query_batch(self._keys, self._vals, self._d,
                                          u_b.long(), v_b.long(),
                                          self.index.n)
            out[lo:lo + B] = chunk.cpu().numpy()
        return out[:len(us)]

    def _padded_sources(self, us: np.ndarray) -> np.ndarray:
        pad = (-len(us)) % self.cfg.source_batch
        self._count_pad(pad)
        return np.concatenate([us, np.full(pad, us[0] if len(us) else 0,
                                           np.int32)]).astype(np.int32)

    def _dispatch_sources(self, us: np.ndarray) -> np.ndarray:
        B = self.cfg.source_batch
        us_p = self._padded_sources(us)
        out = np.empty((len(us_p), self.index.n), np.float32)
        for lo in range(0, len(us_p), B):
            self._record("source", (B, self._push_backend, self._width_cap,
                                   self.index.plan.l_max))
            if self._sharded is not None:
                out[lo:lo + B] = shard_query.sharded_single_source(
                    self._sharded, us_p[lo:lo + B],
                    backend=self._push_backend)
                continue
            out[lo:lo + B] = batched_single_source(
                self._keys, self._vals, self._d, self._layout,
                self._ids(us_p[lo:lo + B]).long(), self._tau,
                n=self.index.n, l_max=self.index.plan.l_max,
                backend=self._push_backend).cpu().numpy()
        return out[:len(us)]

    def _dispatch_topk(self, us: np.ndarray, bucket: int):
        B = self.cfg.source_batch
        us_p = self._padded_sources(us)
        sv = np.empty((len(us_p), bucket), np.float32)
        si = np.empty((len(us_p), bucket), np.int32)
        for lo in range(0, len(us_p), B):
            self._record("topk", (B, bucket, self._push_backend,
                                 self._width_cap, self.index.plan.l_max))
            if self._sharded is not None:
                sv[lo:lo + B], si[lo:lo + B] = shard_query.sharded_topk(
                    self._sharded, us_p[lo:lo + B], bucket,
                    backend=self._push_backend)
                continue
            v, i = batched_topk(
                self._keys, self._vals, self._d, self._layout,
                self._ids(us_p[lo:lo + B]).long(), self._tau,
                n=self.index.n, l_max=self.index.plan.l_max, k=bucket,
                backend=self._push_backend)
            sv[lo:lo + B] = v.cpu().numpy()
            si[lo:lo + B] = i.cpu().numpy()
        return sv[:len(us)], si[:len(us)]

    # ------------------------------------------------------------------
    def pairs(self, us, vs) -> np.ndarray:
        """s(u_i, v_i) for aligned arrays of node ids."""
        us = np.asarray(us, np.int32).ravel()
        vs = np.asarray(vs, np.int32).ravel()
        if us.shape != vs.shape:
            raise ValueError("us and vs must have one shape")
        self._counts["pair"] += len(us)
        out = np.empty(len(us), np.float32)
        miss_pos = []
        for i, (u, v) in enumerate(zip(us.tolist(), vs.tolist())):
            hit = self._cache.get(("pair", min(u, v), max(u, v)))
            if hit is None:
                miss_pos.append(i)
            else:
                out[i] = hit
        if miss_pos:
            got = self._dispatch_pairs(us[miss_pos], vs[miss_pos])
            for j, i in enumerate(miss_pos):
                out[i] = got[j]
                u, v = int(us[i]), int(vs[i])
                self._cache.put(("pair", min(u, v), max(u, v)),
                                float(got[j]))
        return out

    def pair(self, u: int, v: int) -> float:
        return float(self.pairs([u], [v])[0])

    def single_source(self, us) -> np.ndarray:
        """(Q, n) scores for an array of query nodes."""
        us = np.atleast_1d(np.asarray(us, np.int32))
        self._counts["source"] += len(us)
        out = np.empty((len(us), self.index.n), np.float32)
        miss_pos = []
        for i, u in enumerate(us.tolist()):
            hit = self._cache.get(("src", u))
            if hit is None:
                miss_pos.append(i)
            else:
                out[i] = hit
        if miss_pos:
            got = self._dispatch_sources(us[miss_pos])
            for j, i in enumerate(miss_pos):
                out[i] = got[j]
                self._cache.put(("src", int(us[i])), got[j].copy())
        return out

    def topk(self, us, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top-k similar nodes per query: (Q, k') scores + node ids,
        k' = min(k, n), scores descending, ties toward small ids."""
        us = np.atleast_1d(np.asarray(us, np.int32))
        k_eff = min(int(k), self.index.n)
        bucket = self._k_bucket(k_eff)
        self._counts["topk"] += len(us)
        sv = np.empty((len(us), k_eff), np.float32)
        si = np.empty((len(us), k_eff), np.int32)
        miss_pos = []
        for i, u in enumerate(us.tolist()):
            hit = self._cache.get(("topk", u, bucket))
            if hit is None:
                miss_pos.append(i)
            else:
                sv[i], si[i] = hit[0][:k_eff], hit[1][:k_eff]
        if miss_pos:
            gv, gi = self._dispatch_topk(us[miss_pos], bucket)
            for j, i in enumerate(miss_pos):
                sv[i], si[i] = gv[j, :k_eff], gi[j, :k_eff]
                self._cache.put(("topk", int(us[i]), bucket),
                                (gv[j].copy(), gi[j].copy()))
        return sv, si

    # ------------------------------------------------------------------
    # materialized kNN lookups (repro_torch.join)
    # ------------------------------------------------------------------
    def attach_knn(self, knn, allow_stale: bool = False) -> None:
        """Attach a materialized :class:`~repro_torch.join.KnnGraph` so
        ``knn(u)`` answers from the artifact instead of the device. The
        artifact must cover this engine's graph (same n) and, unless
        ``allow_stale``, match the served index's epoch: an artifact
        swept before a hot-swap holds pre-swap scores."""
        if knn.n != self.index.n:
            raise ValueError(f"KnnGraph covers n={knn.n} nodes, engine "
                             f"serves n={self.index.n}")
        if not allow_stale and knn.epoch != self.index.epoch:
            raise ValueError(
                f"KnnGraph was swept at index epoch {knn.epoch}, engine "
                f"serves epoch {self.index.epoch}; re-run the join "
                "(repro_torch.join.run_join) or pass allow_stale=True")
        self._knn = knn

    def knn(self, u: int, k: int | None = None,
            allow_stale: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """(ids, scores) of u's materialized nearest neighbors, from the
        attached :class:`~repro_torch.join.KnnGraph`: a host lookup, no
        device dispatch. A ``swap_index`` moves the served epoch past
        the artifact's, after which lookups raise (counted in
        ``stats()["knn_stale_rejects"]``) until a fresh join is
        attached; ``allow_stale=True`` serves the pre-swap scores
        explicitly. ``k`` truncates the stored row (scores descend)."""
        self._counts["knn"] += 1
        if self._knn is None:
            raise RuntimeError("no KnnGraph attached; run the bulk join "
                               "(repro_torch.join.run_join) and "
                               "attach_knn() its artifact")
        if not allow_stale and self._knn.epoch != self.index.epoch:
            self._counts["knn_stale_rejects"] += 1
            raise RuntimeError(
                f"attached KnnGraph is stale: swept at epoch "
                f"{self._knn.epoch}, index now at epoch "
                f"{self.index.epoch} (hot-swap); re-run the join or "
                "pass allow_stale=True")
        ids, scores = self._knn.neighbors(int(u))
        if k is not None:
            ids, scores = ids[:int(k)], scores[:int(k)]
        return ids, scores

    # ------------------------------------------------------------------
    def warmup(self) -> dict:
        """Dispatch every fixed shape once before traffic arrives
        (builds the kernels on ``cuda``). Returns {path: seconds}.
        Results are not cached; dispatches count under ``warmup_*``."""
        out = {}
        self._in_warmup = True
        try:
            z_pair = np.zeros(self.cfg.pair_batch, np.int32)
            t0 = time.perf_counter()
            self._dispatch_pairs(z_pair, z_pair)
            out["pair"] = time.perf_counter() - t0
            z_src = np.zeros(self.cfg.source_batch, np.int32)
            t0 = time.perf_counter()
            self._dispatch_sources(z_src)
            out["source"] = time.perf_counter() - t0
            buckets = {self._k_bucket(b) for b in self.cfg.k_buckets}
            buckets.add(self.index.n)   # the k > max(buckets) fallback
            for b in sorted(buckets):
                t0 = time.perf_counter()
                self._dispatch_topk(z_src, b)
                out[f"topk@{b}"] = time.perf_counter() - t0
        finally:
            self._in_warmup = False
        return out

    def stats(self) -> dict:
        return {
            **self._counts,
            **self._swaps,
            "epoch": self.index.epoch,
            "stale": self.index.stale,
            "cache_hits": self._cache.hits,
            "cache_misses": self._cache.misses,
            "cache_hits_by_kind": dict(self._cache.hits_by_kind),
            "cache_misses_by_kind": dict(self._cache.misses_by_kind),
            "cache_entries": len(self._cache),
            "knn_attached": self._knn is not None,
            "unique_shapes": sorted(self._shapes),
            "pair_backend": self._pair_backend,
            "push_backend": self._push_backend,
            "device": str(self.device),
            "width_cap": self._width_cap,
            "mesh_shards": (self._sharded.n_shards
                            if self._sharded is not None else 0),
            "quantized": (self.index.quant.scheme
                          if self.index.quant is not None else None),
        }

    @classmethod
    def from_index_file(cls, path: str, g: csr.Graph,
                        config: EngineConfig | None = None,
                        mmap: bool = False, device=None) -> "QueryEngine":
        """Serve an index persisted with ``SlingIndex.save`` on
        ``device`` (``cuda`` unless ``device="cpu"``). ``mmap=True``
        (format v3) maps the artifact read-only in host memory -- O(1)
        load, pages shared between processes -- and install uploads and
        dequantizes it; an eager load reads it onto ``device``."""
        return cls(SlingIndex.load(path, mmap=mmap,
                                   device=None if mmap else device),
                   g, config, device=device)
