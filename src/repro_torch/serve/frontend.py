"""Async, SLO-aware admission frontend over QueryEngine replicas.

Port of ``repro/serve/frontend.py`` over the port's ``QueryEngine``.
``QueryEngine`` (serve/engine.py) is deliberately synchronous: one
caller, one dispatch at a time, batching policy left to the caller.
``ServeFrontend`` is that policy layer (DESIGN.md section 12): the
piece that keeps the device saturated under concurrent, skewed,
deadline-bound traffic.

  * **Deadline-aware batch formation** -- requests are admitted into
    per-(kind, k) open batches that close at ``max_batch`` requests
    *or* ``max_wait`` seconds after the first admission, whichever
    comes first. The close timer is armed at
    ``min(open_since + max_wait, earliest request deadline)``, so an
    expiring request is handled at its exact deadline, never late.
  * **Per-request deadlines, shed-on-expiry** -- a request whose
    deadline passes before its batch dispatches is *shed* (its ticket
    raises :class:`ShedError`), not served late; it never reaches the
    device, so one expired straggler cannot poison a batch's latency.
    Requests already dispatched run to completion (the device batch is
    in flight; results past deadline are still delivered, the caller
    decides what to do with them).
  * **Async dispatch** -- with the production clock, each replica owns
    a dispatch worker thread: admission never blocks on the device.
    The replicas' kernels go to the device's one default stream, so
    their batches run on the card one after another while admission
    and the host side of other batches overlap them. With a
    :class:`~repro_torch.serve.clock.VirtualClock` the frontend runs
    inline on the calling thread -- fully deterministic, zero sleeps
    (the test seam).
  * **Replica routing** -- N ``QueryEngine`` replicas over one shared
    index artifact (each holds its own device copy of the table);
    batches route round-robin or least-loaded (fewest in-flight
    batches). Each replica keeps its own LRU and dispatch-shape set;
    ``stats()`` aggregates them.
  * **Epoch-coordinated hot-swap** -- ``swap_index()`` is a barrier:
    admissions keep queueing, every open batch is closed and
    dispatched at the *old* epoch, in-flight work drains, then every
    replica hot-swaps (``QueryEngine.swap_index``), then
    formation resumes at the new epoch. A dispatched batch therefore
    never mixes epochs, and ``batch_log`` records the served epoch
    per batch as the auditable trail.

Everything time-related goes through the injectable clock
(serve/clock.py); the scheduler itself has no ``time.sleep`` and no
hidden wall-clock reads, which is what makes the scheduler's tests
deterministic. The frontend's engines never touch the process-wide
``core/device_state`` cache: each holds its own tensors.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from collections import deque

import numpy as np

from repro_torch.serve.clock import MonotonicClock, VirtualClock
from repro_torch.serve.engine import EngineConfig, QueryEngine


class ShedError(RuntimeError):
    """The request's deadline expired before its batch dispatched."""


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    max_batch: int = 8          # single-source/top-k close-at-size
    max_pair_batch: int = 64    # pair close-at-size
    max_wait: float = 0.002     # seconds from first admission to close
    default_timeout: float | None = None  # per-request deadline budget
    replicas: int = 1
    routing: str = "least_loaded"   # "least_loaded" | "round_robin"
    dispatch: str = "auto"          # "inline" | "thread" | "auto"
    log_cap: int = 4096             # batch_log ring size
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    def cap(self, kind: str) -> int:
        return self.max_pair_batch if kind == "pair" else self.max_batch


class Ticket:
    """Handle for one admitted request.

    ``result()`` returns the query answer (pair -> float, source ->
    (n,) scores, topk -> (scores, ids)); it raises :class:`ShedError`
    if the deadline expired first. With the production clock it
    blocks; with a virtual clock the answer is already there once the
    test advanced/flushed (a missing one raises ``TimeoutError``
    instead of deadlocking a sleepless test).
    """

    __slots__ = ("kind", "submit_t", "deadline", "fulfil_t", "shed",
                 "_value", "_event")

    def __init__(self, kind: str, submit_t: float,
                 deadline: float | None):
        self.kind = kind
        self.submit_t = submit_t
        self.deadline = deadline
        self.fulfil_t: float | None = None
        self.shed = False
        self._value = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                "request not complete -- advance the clock, flush(), "
                "or pass a longer timeout")
        if self.shed:
            # deadline is None when the ticket was shed for a reason
            # other than expiry (e.g. its batch's worker failed)
            if self.deadline is None:
                raise ShedError(
                    f"{self.kind} request shed before dispatch "
                    f"(batch failed or frontend shut down)")
            raise ShedError(
                f"{self.kind} request shed: deadline {self.deadline:.6f} "
                f"expired before dispatch")
        return self._value

    @property
    def latency(self) -> float | None:
        """Admission-to-fulfilment in clock seconds (None until done,
        shed time for shed tickets)."""
        if self.fulfil_t is None:
            return None
        return self.fulfil_t - self.submit_t

    def _fulfil(self, value, t: float) -> None:
        self._value = value
        self.fulfil_t = t
        self._event.set()

    def _shed(self, t: float) -> None:
        self.shed = True
        self.fulfil_t = t
        self._event.set()


@dataclasses.dataclass
class _Request:
    u: int
    v: int                      # pair partner (unused otherwise)
    k: int                      # topk k (unused otherwise)
    deadline: float | None
    ticket: Ticket


@dataclasses.dataclass
class _Queue:
    items: list
    open_since: float
    timer: object = None
    timer_when: float = 0.0


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One dispatched batch (the epoch-purity / bound audit trail)."""
    kind: str
    key: tuple
    size: int
    cap: int
    epoch: int
    replica: int
    reason: str                 # "size" | "wait" | "flush" | "swap"
    opened: float
    closed: float


class ServeFrontend:
    """SLO-aware admission + routing over ``QueryEngine`` replicas."""

    # Lock contract (the reference's declaration, checked by its
    # LockDisciplinePass): these fields are only mutated
    # under self._lock (self._idle is a Condition sharing it), inside
    # *_locked helpers, or in __init__; and nothing blocking --
    # dispatch, drain, joins -- runs while the lock is held.
    _SLINGLINT_GUARDED = {
        "locks": ("_lock", "_idle"),
        "fields": ("_queues", "_inflight", "_rr", "_epoch",
                   "_swapping", "_closed", "_counts", "_occ_sum",
                   "batch_log"),
    }

    def __init__(self, index, g, config: FrontendConfig | None = None,
                 clock=None, engines=None, device=None):
        """``R = config.replicas`` engines over ``index`` on ``device``
        (``cuda`` unless ``device="cpu"``), or the given ``engines``."""
        self.cfg = config or FrontendConfig()
        if self.cfg.max_wait <= 0:
            raise ValueError("max_wait must be > 0")
        if self.cfg.routing not in ("least_loaded", "round_robin"):
            raise ValueError(f"unknown routing {self.cfg.routing!r}")
        if (self.cfg.dispatch == "thread"
                and isinstance(clock, VirtualClock)):
            raise ValueError("thread dispatch needs a real clock; the "
                             "VirtualClock seam is inline-only")
        if engines is None:
            if self.cfg.replicas < 1:
                raise ValueError("replicas must be >= 1")
            engines = [QueryEngine(index, g, self.cfg.engine, device=device)
                       for _ in range(self.cfg.replicas)]
        self.engines = list(engines)
        # the clock (and its timer thread) only after everything that
        # can refuse: a refused frontend leaves no thread behind
        self._own_clock = clock is None
        self.clock = clock if clock is not None else MonotonicClock()
        mode = self.cfg.dispatch
        if mode == "auto":
            mode = ("thread" if isinstance(self.clock, MonotonicClock)
                    else "inline")
        self._mode = mode
        self._lock = threading.RLock()
        self._idle = threading.Condition(self._lock)
        self._queues: dict[tuple, _Queue] = {}
        self._inflight = [0] * len(self.engines)
        self._rr = 0
        self._epoch = int(self.engines[0].index.epoch)
        self._swapping = False
        self._closed = False
        self.batch_log: deque[BatchRecord] = deque(maxlen=self.cfg.log_cap)
        self._counts = {"admitted": 0, "shed": 0, "served": 0,
                        "batches": 0, "swaps": 0, "failed": 0}
        self._occ_sum = 0.0
        self._workers = []
        if self._mode == "thread":
            import queue as _qmod
            self._work: list[_qmod.Queue] = []
            for r in range(len(self.engines)):
                wq = _qmod.Queue()
                th = threading.Thread(target=self._worker, args=(wq,),
                                      daemon=True,
                                      name=f"sling-dispatch-{r}")
                th.start()
                self._work.append(wq)
                self._workers.append(th)

    # ------------------------------------------------------------------
    @classmethod
    def from_index_file(cls, path: str, g,
                        config: "FrontendConfig | None" = None,
                        clock=None, mmap: bool = False,
                        device=None) -> "ServeFrontend":
        """Serve a persisted index artifact (``SlingIndex.save``) on
        ``device`` (``cuda`` unless ``device="cpu"``).

        ``mmap=True`` (format v3) maps the artifact read-only ONCE and
        every replica engine installs from the same pages -- the N
        replicas share one on-disk copy instead of N host-RAM copies;
        an eager load reads it onto ``device`` once.
        """
        from repro_torch.core.index import SlingIndex
        return cls(SlingIndex.load(path, mmap=mmap,
                                   device=None if mmap else device),
                   g, config, clock=clock, device=device)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit_pair(self, u: int, v: int,
                    timeout: float | None = None) -> Ticket:
        return self._submit("pair", ("pair",),
                            _Request(int(u), int(v), 0, None, None),
                            timeout)

    def submit_source(self, u: int,
                      timeout: float | None = None) -> Ticket:
        return self._submit("source", ("source",),
                            _Request(int(u), 0, 0, None, None), timeout)

    def submit_topk(self, u: int, k: int,
                    timeout: float | None = None) -> Ticket:
        # k is part of the batch key: engine.topk takes one k per
        # batch (it buckets internally, so distinct-k queues still
        # share dispatch shapes)
        return self._submit("topk", ("topk", int(k)),
                            _Request(int(u), 0, int(k), None, None),
                            timeout)

    def _submit(self, kind: str, key: tuple, req: _Request,
                timeout: float | None) -> Ticket:
        unit = None
        with self._lock:
            if self._closed:
                raise RuntimeError("frontend is closed")
            now = self.clock.now()
            if timeout is None:
                timeout = self.cfg.default_timeout
            deadline = None if timeout is None else now + float(timeout)
            ticket = Ticket(kind, now, deadline)
            self._counts["admitted"] += 1
            if deadline is not None and deadline <= now:
                self._counts["shed"] += 1
                ticket._shed(now)
                return ticket
            req.deadline = deadline
            req.ticket = ticket
            q = self._queues.get(key)
            if q is None:
                q = _Queue(items=[], open_since=now)
                self._queues[key] = q
            if not q.items:
                # fresh window: the wait bound is measured from the
                # first admission of *this* batch
                q.open_since = now
                self._clear_timer_locked(q)
            q.items.append(req)
            if len(q.items) >= self.cfg.cap(kind) and not self._swapping:
                unit = self._close_locked(key, "size")
            else:
                self._arm_timer_locked(key)
        if unit:
            self._dispatch(unit)
        return ticket

    # ------------------------------------------------------------------
    # batch close machinery (all *_locked helpers run under self._lock)
    # ------------------------------------------------------------------
    def _arm_timer_locked(self, key: tuple) -> None:
        q = self._queues[key]
        now = self.clock.now()
        target = q.open_since + self.cfg.max_wait
        for r in q.items:
            if r.deadline is not None:
                target = min(target, r.deadline)
        if self._swapping:
            # during a swap only deadline expiry may fire; the close
            # itself waits for the barrier to lift
            dls = [r.deadline for r in q.items if r.deadline is not None]
            if not dls:
                self._clear_timer_locked(q)
                return
            target = min(dls)
        if q.timer is not None and not q.timer.cancelled \
                and abs(q.timer_when - target) < 1e-12:
            return
        self._clear_timer_locked(q)
        q.timer = self.clock.schedule(max(0.0, target - now),
                                      lambda: self._on_timer(key))
        q.timer_when = target

    def _clear_timer_locked(self, q: _Queue) -> None:
        if q.timer is not None:
            self.clock.cancel(q.timer)
            q.timer = None

    def _shed_expired_locked(self, q: _Queue) -> None:
        now = self.clock.now()
        keep = []
        for r in q.items:
            if r.deadline is not None and r.deadline <= now:
                self._counts["shed"] += 1
                r.ticket._shed(now)
            else:
                keep.append(r)
        q.items = keep

    def _on_timer(self, key: tuple) -> None:
        unit = None
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                return
            q.timer = None
            if not q.items:
                return
            self._shed_expired_locked(q)
            if not q.items:
                return
            now = self.clock.now()
            if self._swapping:
                self._arm_timer_locked(key)
            elif now >= q.open_since + self.cfg.max_wait - 1e-12:
                unit = self._close_locked(key, "wait")
            else:
                self._arm_timer_locked(key)
        if unit:
            self._dispatch(unit)

    def _close_locked(self, key: tuple, reason: str):
        """Pop the open batch, shed expired members, pick a replica.
        Returns a dispatch unit or None (everything shed/empty)."""
        q = self._queues.get(key)
        if q is None:
            return None
        self._clear_timer_locked(q)
        self._shed_expired_locked(q)
        items, opened = q.items, q.open_since
        q.items = []
        if not items:
            return None
        loads = [self._inflight[r] for r in range(len(self.engines))]
        if self._mode == "thread":
            loads = [l + self._work[r].qsize()
                     for r, l in enumerate(loads)]
        if self.cfg.routing == "round_robin":
            replica = self._rr % len(self.engines)
            self._rr += 1
        else:
            replica = int(np.argmin(loads))
        self._inflight[replica] += 1
        return (replica, key, items, reason, opened)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _dispatch(self, unit) -> None:
        if self._mode == "thread":
            self._work[unit[0]].put(unit)
        else:
            self._run_unit(unit)

    def _worker(self, wq) -> None:
        while True:
            unit = wq.get()
            if unit is None:
                return
            try:
                self._run_unit(unit)
            except Exception:      # keep the worker alive; the batch's
                traceback.print_exc()       # tickets surface the gap
                self._fail_unit(unit)

    def _fail_unit(self, unit) -> None:
        replica, _key, items, _reason, _opened = unit
        now = self.clock.now()
        for r in items:
            if not r.ticket.done():
                r.ticket._shed(now)
        with self._lock:
            self._counts["shed"] += len(items)
            self._counts["failed"] += len(items)
            self._inflight[replica] -= 1
            self._idle.notify_all()

    def _run_unit(self, unit) -> None:
        replica, key, items, reason, opened = unit
        eng = self.engines[replica]
        kind = key[0]
        t0 = self.clock.now()
        epoch = self._epoch
        us = np.asarray([r.u for r in items], np.int32)
        if kind == "pair":
            vs = np.asarray([r.v for r in items], np.int32)
            vals = eng.pairs(us, vs)
            results = [float(v) for v in vals]
        elif kind == "source":
            rows = eng.single_source(us)
            results = [rows[i].copy() for i in range(len(items))]
        else:
            sv, si = eng.topk(us, key[1])
            results = [(sv[i].copy(), si[i].copy())
                       for i in range(len(items))]
        t1 = self.clock.now()
        for r, val in zip(items, results):
            r.ticket._fulfil(val, t1)
        with self._lock:
            self._counts["served"] += len(items)
            self._counts["batches"] += 1
            self._occ_sum += len(items) / self.cfg.cap(kind)
            self.batch_log.append(BatchRecord(
                kind=kind, key=key, size=len(items),
                cap=self.cfg.cap(kind), epoch=epoch, replica=replica,
                reason=reason, opened=opened, closed=t0))
            self._inflight[replica] -= 1
            self._idle.notify_all()

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------
    def flush(self) -> int:
        """Close every open batch now (deadline-checked); returns the
        number of batches dispatched. No-op during a swap barrier --
        the barrier already flushed, and new admissions wait for the
        new epoch."""
        units = []
        with self._lock:
            if self._swapping:
                return 0
            for key in list(self._queues):
                unit = self._close_locked(key, "flush")
                if unit:
                    units.append(unit)
        for unit in units:
            self._dispatch(unit)
        return len(units)

    def drain(self, timeout: float | None = None) -> None:
        """Block until no batch is in flight (thread dispatch)."""
        with self._idle:
            if not self._idle.wait_for(
                    lambda: sum(self._inflight) == 0
                    and (self._mode != "thread"
                         or all(w.qsize() == 0 for w in self._work)),
                    timeout=timeout):
                raise TimeoutError("in-flight batches did not drain")

    def swap_index(self, index, g, affected=None) -> dict:
        """Barrier hot-swap across every replica.

        Old-epoch: open batches close and dispatch *before* any
        replica swaps (requests admitted before the barrier are served
        from the index they were admitted against). In-flight work
        drains, every replica runs ``engine.swap_index``, and only
        then does batch formation resume -- so no dispatched batch can
        mix epochs (``batch_log`` records each batch's epoch). Returns
        aggregate swap metrics;
        ``recompiles``/``cache_dropped`` are summed over replicas.
        """
        t0 = time.perf_counter()
        units = []
        with self._lock:
            if self._swapping:
                raise RuntimeError("swap already in progress")
            self._swapping = True
            for key in list(self._queues):
                unit = self._close_locked(key, "swap")
                if unit:
                    units.append(unit)
        barrier_batches = len(units)
        for unit in units:
            self._dispatch(unit)
        self.drain()
        reports = [eng.swap_index(index, g, affected=affected)
                   for eng in self.engines]
        units = []
        with self._lock:
            self._epoch = int(self.engines[0].index.epoch)
            self._counts["swaps"] += 1
            self._swapping = False
            now = self.clock.now()
            for key, q in self._queues.items():
                if not q.items:
                    continue
                # requests queued during the barrier: close immediately
                # if their window already elapsed, else re-arm
                if now >= q.open_since + self.cfg.max_wait - 1e-12 \
                        or len(q.items) >= self.cfg.cap(key[0]):
                    unit = self._close_locked(key, "wait")
                    if unit:
                        units.append(unit)
                else:
                    self._arm_timer_locked(key)
        for unit in units:
            self._dispatch(unit)
        return {
            "swap_ms": 1e3 * (time.perf_counter() - t0),
            "recompiles": sum(r["recompiles"] for r in reports),
            "cache_dropped": sum(r["cache_dropped"] for r in reports),
            "epoch": self._epoch,
            "barrier_batches": barrier_batches,
            "replicas": len(self.engines),
        }

    def warmup(self) -> dict:
        """Dispatch every replica's fixed shapes once; returns the max
        per-path seconds across replicas."""
        out: dict[str, float] = {}
        for eng in self.engines:
            for path, secs in eng.warmup().items():
                out[path] = max(out.get(path, 0.0), secs)
        return out

    def stats(self) -> dict:
        """Frontend counters + per-replica engine stats + aggregates.

        ``cache_hits``/``cache_misses``/``*_by_kind`` are summed over
        replicas (each replica keeps its own LRU); ``per_replica``
        carries the raw ``QueryEngine.stats()`` dicts;
        ``unique_shapes`` is the union -- the frontend-level fixed
        shape-set gate. ``failed`` counts the tickets of batches whose
        engine call raised on a worker (they are in ``shed`` too).
        """
        with self._lock:
            reps = [eng.stats() for eng in self.engines]
            hits_by: dict[str, int] = {}
            miss_by: dict[str, int] = {}
            for r in reps:
                for k, v in r["cache_hits_by_kind"].items():
                    hits_by[k] = hits_by.get(k, 0) + v
                for k, v in r["cache_misses_by_kind"].items():
                    miss_by[k] = miss_by.get(k, 0) + v
            shapes = set()
            for r in reps:
                shapes |= {tuple(s) for s in r["unique_shapes"]}
            batches = self._counts["batches"]
            return {
                **self._counts,
                "pending": sum(len(q.items)
                               for q in self._queues.values()),
                "inflight": sum(self._inflight),
                "mean_occupancy": (self._occ_sum / batches
                                   if batches else 0.0),
                "epoch": self._epoch,
                "replicas": len(self.engines),
                "routing": self.cfg.routing,
                "dispatch": self._mode,
                "cache_hits": sum(r["cache_hits"] for r in reps),
                "cache_misses": sum(r["cache_misses"] for r in reps),
                "cache_hits_by_kind": hits_by,
                "cache_misses_by_kind": miss_by,
                "unique_shapes": sorted(shapes),
                "per_replica": reps,
            }

    def close(self) -> None:
        """Flush, stop workers, release the clock (if owned).

        ``_closed`` flips *before* the final flush so a racing
        ``submit`` cannot enqueue a batch behind the worker shutdown
        sentinel (a ticket admitted there would never be fulfilled)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.flush()
        if self._mode == "thread":
            self.drain(timeout=60.0)
            for wq in self._work:
                wq.put(None)
            for th in self._workers:
                th.join(timeout=5.0)
        with self._lock:
            for q in self._queues.values():
                self._clear_timer_locked(q)
        if self._own_clock:
            self.clock.close()

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
