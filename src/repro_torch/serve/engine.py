"""Unified SimRank query engine on one device: pairs, single-source and
top-k from a built :class:`~repro_torch.core.index.SlingIndex`.

Port of ``repro/serve/engine.py`` (single device; hot-swap, invalidation,
meshes and kNN attachments are later slices). The dispatch contract is
the reference's:

  * **fixed batch shapes** -- requests are chunked and padded to
    ``pair_batch`` / ``source_batch``; the packed table is padded to a
    capacity bucket of its width. Eager PyTorch compiles nothing, so
    the fixed set of dispatch shapes (``stats()["unique_shapes"]``,
    which must not grow after ``warmup``) is the port's counterpart of
    the reference's compile-once rule;
  * **k-bucketing** -- top-k rounds k up to a configured bucket (or n
    past the largest) and slices the answer;
  * **LRU score cache** keyed by (type, node(s), bucket), with the
    symmetric pair key (s(u,v) = s(v,u));
  * **backends** -- ``pair_backend``: "kernel" (the Hopper ``hp_join``
    over sqrt(d)-folded rows) or "join" (the searchsorted join);
    ``push_backend``: "kernel" (the Hopper Horner step) or "plain".
    "auto" resolves by the engine's device: the kernels on ``cuda``,
    the plain versions on ``cpu``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import hp_index
from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.core.index import SlingIndex, _pair_query_batch
from repro_torch.core.single_source import (batched_single_source,
                                            prune_tau)
from repro_torch.core.topk import batched_topk
from repro_torch.device import resolve_device
from repro_torch.graph import csr
from repro_torch.kernels.hp_join import fold_sqrt_d, hp_join
from repro_torch.kernels.horner_push import (PushLayout,
                                             resolve_push_backend)

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
    # serve an index whose diagonal carries no eps_d certificate; off by
    # default because the Theorem-1 bound then does not hold
    allow_uncertified: bool = False


class QueryEngine:
    """Front-end over a SlingIndex for all three SimRank query types,
    on ``device`` (``cuda`` unless ``device="cpu"``)."""

    def __init__(self, index: SlingIndex, g: csr.Graph,
                 config: EngineConfig | None = None, device=None):
        self.cfg = config or EngineConfig()
        if index.uncertified_d and not self.cfg.allow_uncertified:
            raise ValueError(
                "index diagonal is uncertified: the Theorem-1 eps bound "
                "does not hold. Rebuild with a certified diagonal, or "
                "pass EngineConfig(allow_uncertified=True) to serve it "
                "anyway")
        if index.n < 1:
            raise ValueError("cannot serve an empty index")
        self.device = resolve_device(device)
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
        self._counts = {"pair": 0, "source": 0, "topk": 0,
                        "batches": 0, "pad_slots": 0,
                        "warmup_batches": 0, "warmup_pad_slots": 0}
        self._in_warmup = False
        self._width_cap = hp_index.capacity_bucket(index.hp.width)
        self._install(index, g)

    # ------------------------------------------------------------------
    def _padded(self, t: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((t.shape[0], self._width_cap), fill,
                         dtype=t.dtype, device=self.device)
        out[:, :t.shape[1]] = t.to(self.device)
        return out

    def _install(self, index: SlingIndex, g: csr.Graph) -> None:
        """Upload ``index``/``g`` with the packed table padded to the
        width bucket (PAD keys, zero values: inert in every path)."""
        self._keys = self._padded(index.hp.keys, INT32_PAD_KEY)
        self._vals = self._padded(index.vals_f32(), 0.0)
        self._d = index.d.to(self.device, torch.float32)
        self._layout = PushLayout.from_graph(g, index.plan.sqrt_c,
                                             self.device)
        self._tau = prune_tau(index.plan)
        self._folded_keys = self._folded_vals = None
        if self._pair_backend == "kernel":
            fk, fv = fold_sqrt_d(index)
            self._folded_keys = self._padded(fk, INT32_PAD_KEY)
            self._folded_vals = self._padded(fv, 0.0)
        self.index = index
        self.g = g

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
        self._shapes.add((kind,) + tuple(shape))

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
            self._record("pair", (B, self._pair_backend))
            if self._pair_backend == "kernel":
                chunk = hp_join(self._folded_keys, self._folded_vals,
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
            self._record("source", (B, self._push_backend))
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
            self._record("topk", (B, bucket, self._push_backend))
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
            "cache_hits": self._cache.hits,
            "cache_misses": self._cache.misses,
            "cache_hits_by_kind": dict(self._cache.hits_by_kind),
            "cache_misses_by_kind": dict(self._cache.misses_by_kind),
            "cache_entries": len(self._cache),
            "unique_shapes": sorted(self._shapes),
            "pair_backend": self._pair_backend,
            "push_backend": self._push_backend,
            "device": str(self.device),
            "width_cap": self._width_cap,
        }
