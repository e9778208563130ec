"""Injectable clock/timer seam for the serving frontend.

Port of ``repro/serve/clock.py`` (pure threading, the port's own copy).
The frontend (serve/frontend.py, DESIGN.md section 12) never reads
``time`` or sleeps directly: every "what time is it" and every "call
me back in dt seconds" goes through a clock object with three
methods -- ``now()``, ``schedule(delay, fn) -> handle``, and
``cancel(handle)``. Two implementations:

  * :class:`MonotonicClock` -- production. ``now()`` is
    ``time.monotonic``; timers fire on a single daemon thread ordered
    by deadline (one thread for the whole frontend, not one per
    timer). Callbacks run *off* the clock's internal lock, so a
    callback may freely schedule/cancel further timers.
  * :class:`VirtualClock` -- the deterministic test double. Time only
    moves when the test calls ``advance(dt)``, which fires every due
    timer *at its exact deadline* (``now()`` reads the fire time
    inside the callback) in (deadline, schedule-order) order, all on
    the calling thread. No wall-clock sleeps anywhere, so scheduler
    tests cannot flake and an interleaving replays bit-identically.

Both hand out :class:`TimerHandle` objects whose ``cancel()`` is
idempotent and safe to race with firing (a cancelled timer that
already popped is a no-op).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
import traceback


class TimerHandle:
    """One scheduled callback; total order = (deadline, seq)."""

    __slots__ = ("when", "seq", "fn", "cancelled")

    def __init__(self, when: float, seq: int, fn):
        self.when = when
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        self.fn = None          # drop the closure (it may pin batches)

    def __lt__(self, other: "TimerHandle") -> bool:
        return (self.when, self.seq) < (other.when, other.seq)


class VirtualClock:
    """Deterministic manual-advance clock (the test seam).

    ``advance(dt)`` runs every timer with deadline <= now + dt, in
    deadline order, setting ``now()`` to each timer's exact deadline
    while its callback runs -- so a batch-close callback scheduled for
    t=0.005 observes ``now() == 0.005`` even when the test advanced by
    1.0 in one call. Callbacks scheduled *during* an advance with a
    deadline inside the window fire in the same advance.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._heap: list[TimerHandle] = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    def schedule(self, delay: float, fn) -> TimerHandle:
        t = TimerHandle(self._now + max(0.0, float(delay)),
                        next(self._seq), fn)
        heapq.heappush(self._heap, t)
        return t

    def cancel(self, handle: TimerHandle) -> None:
        handle.cancel()

    def advance(self, dt: float = 0.0) -> None:
        target = self._now + float(dt)
        while self._heap and self._heap[0].when <= target:
            t = heapq.heappop(self._heap)
            if t.cancelled:
                continue
            self._now = t.when
            t.fn()
        self._now = target

    def pending(self) -> int:
        """Live (uncancelled) timers still queued."""
        return sum(1 for t in self._heap if not t.cancelled)

    def close(self) -> None:
        self._heap.clear()


class MonotonicClock:
    """Wall-clock timers on one daemon thread (production)."""

    # Lock contract (the reference's declaration, checked by its
    # LockDisciplinePass): the heap and the closed flag are only touched
    # under self._cv; _run's manual acquire/release pairs are lexical.
    # (VirtualClock is single-threaded by design and declares nothing.)
    _SLINGLINT_GUARDED = {
        "locks": ("_cv",),
        "fields": ("_heap", "_closed"),
    }

    def __init__(self):
        self._heap: list[TimerHandle] = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sling-serve-clock")
        self._thread.start()

    def now(self) -> float:
        return time.monotonic()

    def schedule(self, delay: float, fn) -> TimerHandle:
        t = TimerHandle(self.now() + max(0.0, float(delay)),
                        next(self._seq), fn)
        with self._cv:
            if self._closed:
                raise RuntimeError("clock is closed")
            heapq.heappush(self._heap, t)
            self._cv.notify()
        return t

    def cancel(self, handle: TimerHandle) -> None:
        handle.cancel()
        with self._cv:
            self._cv.notify()

    def _run(self) -> None:
        self._cv.acquire()
        try:
            while not self._closed:
                while self._heap and self._heap[0].cancelled:
                    heapq.heappop(self._heap)
                if not self._heap:
                    self._cv.wait()
                    continue
                delay = self._heap[0].when - self.now()
                if delay > 0:
                    self._cv.wait(delay)
                    continue
                t = heapq.heappop(self._heap)
                # snapshot fn while holding the lock: cancel() may race
                # the pop and null out t.fn between our check and call
                fn = t.fn
                if t.cancelled or fn is None:
                    continue
                # run the callback off the lock: it may schedule().
                # Swallow callback errors -- one bad (or racing-cancel)
                # callback must not kill the shared timer thread, or
                # every later max_wait/deadline timer silently never
                # fires.
                self._cv.release()
                try:
                    fn()
                except Exception:
                    traceback.print_exc()
                finally:
                    self._cv.acquire()
        finally:
            self._cv.release()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._heap.clear()
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
