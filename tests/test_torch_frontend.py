"""The port's SLO-aware serving frontend (repro_torch.serve.frontend,
clock, load) under the reference's scheduler tests (tests/test_frontend.py)
case by case, plus the differential: the same scripted admissions and
VirtualClock advances go into the reference's frontend (JAX engines)
and the port's, and their batch logs must be equal field by field,
their shed sets equal and their answers within BACKEND_ATOL.

Everything runs on the VirtualClock seam except the bounded
thread-dispatch checks: no ``time.sleep`` anywhere, and the conftest
deadline guard (the ``serve`` marker) turns a hung worker into a
failure. The port's engines run on the CPU here (their plain backends).
"""
import copy
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.core import update as rupdate
from repro.serve import EngineConfig as REngineConfig
from repro.serve import FrontendConfig as RFrontendConfig
from repro.serve import ServeFrontend as RServeFrontend
from repro.serve import VirtualClock as RVirtualClock
from repro.serve import zipf_nodes as rzipf_nodes
from repro.serve import zipf_weights as rzipf_weights
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core import update as tupdate
from repro_torch.serve import (EngineConfig, FrontendConfig, QueryEngine,
                               ServeFrontend, ShedError, VirtualClock,
                               zipf_nodes, zipf_weights)

pytestmark = pytest.mark.serve

ATOL = oracle.BACKEND_ATOL
ECFG = EngineConfig(pair_batch=8, source_batch=4, cache_size=64,
                    k_buckets=(4, 16))
RECFG = REngineConfig(pair_batch=8, source_batch=4, cache_size=64,
                      k_buckets=(4, 16))
MAX_WAIT = 0.005


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's ops here are tiny and dispatch-bound: one intra-op
    thread keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carry(ri, g):
    """The reference index and graph as the port's objects (CPU)."""
    tg = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                   ri.hp.keys, ri.vals_f32(), ri.hp.counts,
                                   builder=ri.builder, device="cpu")
    return ti, tg


@pytest.fixture(scope="module")
def port150(small_graph, sling_index):
    """conftest.py's 150-node reference index, carried to the port."""
    ti, tg = _carry(sling_index, small_graph)
    return ti, tg


@pytest.fixture(scope="module")
def stale150(small_graph):
    """A port index of the 150-node graph built with a staleness
    reserve (the swap tests repair it in place: build per test)."""
    tg = convert.graph_from_arrays(small_graph.n, small_graph.edge_src,
                                   small_graph.edge_dst)
    return lambda: tbuild.build_index(tg, eps=0.1, seed=0, stale_frac=0.3,
                                      device="cpu"), tg


def make_frontend(index, g, clock, **over):
    cfg = dict(max_batch=3, max_pair_batch=4, max_wait=MAX_WAIT,
               engine=over.pop("engine", ECFG))
    cfg.update(over)
    return ServeFrontend(index, g, FrontendConfig(**cfg), clock=clock,
                         device="cpu")


def direct(index, g, cfg=ECFG):
    return QueryEngine(index, g, cfg, device="cpu")


# ----------------------------------------------------------------------
# the clock seam itself
# ----------------------------------------------------------------------
def test_virtual_clock_fires_in_order_at_exact_deadlines():
    clk = VirtualClock()
    seen = []
    clk.schedule(0.5, lambda: seen.append(("b", clk.now())))
    clk.schedule(0.2, lambda: seen.append(("a", clk.now())))
    h = clk.schedule(0.3, lambda: seen.append(("cancelled", clk.now())))
    clk.cancel(h)
    # a callback scheduling inside the advance window fires in the
    # same advance, at its own deadline
    clk.schedule(
        0.1, lambda: clk.schedule(
            0.25, lambda: seen.append(("nested", clk.now()))))
    clk.advance(1.0)
    assert seen == [("a", 0.2), ("nested", 0.35), ("b", 0.5)]
    assert clk.now() == 1.0
    assert clk.pending() == 0


@pytest.mark.parametrize("pass_name", ["ClockSeamPass",
                                       "LockDisciplinePass"])
def test_scheduler_passes_the_reference_lint(pass_name):
    """The reference's static checks over the port's frontend and clock:
    no wall-clock reads or sleeps outside the clock seam, and the
    ``_SLINGLINT_GUARDED`` lock contracts hold."""
    from repro import analysis
    from repro.analysis import ast_passes
    from repro_torch.serve import clock as clock_mod
    from repro_torch.serve import frontend as frontend_mod

    findings = analysis.check_modules(getattr(ast_passes, pass_name)(),
                                      [clock_mod, frontend_mod])
    assert findings == [], [f.message for f in findings]


def test_monotonic_clock_timer_thread_survives_bad_callbacks():
    """A raising callback -- or a cancel() racing the fire so the
    handle's fn is already nulled -- must not kill the shared timer
    thread: later timers still fire."""
    from repro_torch.serve.clock import MonotonicClock

    clk = MonotonicClock()
    try:
        def boom():
            raise RuntimeError("buggy callback")

        clk.schedule(0.0, boom)
        racing = clk.schedule(0.0, boom)
        racing.fn = None        # cancel() won the race mid-pop
        fired = threading.Event()
        clk.schedule(0.01, fired.set)
        assert fired.wait(5.0), "timer thread died"
    finally:
        clk.close()
    assert not clk._thread.is_alive()


def test_shed_ticket_without_deadline_raises_shed_error():
    from repro_torch.serve.frontend import Ticket

    t = Ticket("source", 0.0, None)
    t._shed(1.0)
    with pytest.raises(ShedError, match="shed"):
        t.result(timeout=0)


# ----------------------------------------------------------------------
# batch formation: close at size OR wait, whichever first
# ----------------------------------------------------------------------
def test_wait_close_fires_at_exactly_max_wait(port150):
    clk = VirtualClock()
    fe = make_frontend(*port150, clk)
    t = fe.submit_source(3)
    clk.advance(MAX_WAIT * 0.99)
    assert not t.done()                      # still inside the window
    clk.advance(MAX_WAIT * 0.01)
    assert t.done()
    rec = fe.batch_log[-1]
    assert rec.reason == "wait" and rec.closed == pytest.approx(MAX_WAIT)
    assert t.latency == pytest.approx(MAX_WAIT)
    fe.close()


def test_size_close_fires_immediately_without_advancing(port150):
    clk = VirtualClock()
    fe = make_frontend(*port150, clk)
    tickets = [fe.submit_source(i) for i in range(3)]   # max_batch = 3
    assert all(t.done() for t in tickets)
    assert fe.batch_log[-1].reason == "size"
    assert fe.batch_log[-1].size == 3
    before = len(fe.batch_log)
    clk.advance(10 * MAX_WAIT)
    assert len(fe.batch_log) == before
    fe.close()


def test_batches_never_exceed_size_or_wait(port150):
    clk = VirtualClock()
    fe = make_frontend(*port150, clk)
    rng = np.random.default_rng(7)
    n = port150[0].n
    for _ in range(120):
        r = rng.random()
        if r < 0.4:
            fe.submit_source(int(rng.integers(n)))
        elif r < 0.7:
            fe.submit_pair(int(rng.integers(n)), int(rng.integers(n)))
        else:
            fe.submit_topk(int(rng.integers(n)), int(rng.choice([3, 9])))
        if rng.random() < 0.5:
            clk.advance(float(rng.uniform(0, 1.5 * MAX_WAIT)))
    clk.advance(MAX_WAIT)
    fe.flush()
    assert fe.stats()["pending"] == 0
    assert len(fe.batch_log) > 10
    for rec in fe.batch_log:
        assert rec.size <= rec.cap
        assert rec.closed - rec.opened <= MAX_WAIT + 1e-12
        if rec.reason == "size":
            assert rec.size == rec.cap
        if rec.reason == "wait":
            assert rec.closed - rec.opened == pytest.approx(MAX_WAIT)
    fe.close()


# ----------------------------------------------------------------------
# equivalence: any admission interleaving == direct QueryEngine calls
# ----------------------------------------------------------------------
def _script(seed: int, n: int, steps: int = 60, timeouts: bool = False):
    """A seeded list of admissions, advances and flushes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        r = rng.random()
        to = (float(rng.choice([MAX_WAIT / 4, MAX_WAIT * 3]))
              if timeouts and rng.random() < 0.3 else None)
        if r < 0.35:
            out.append(("source", int(rng.integers(n)), None, to))
        elif r < 0.6:
            out.append(("pair", int(rng.integers(n)),
                        int(rng.integers(n)), to))
        elif r < 0.8:
            out.append(("topk", int(rng.integers(n)),
                        int(rng.choice([3, 9])), to))
        elif r < 0.95:
            out.append(("advance", float(rng.uniform(0, 2 * MAX_WAIT)),
                        None, None))
        else:
            out.append(("flush", None, None, None))
    return out


def _play(fe, clk, script):
    """Run ``script``; returns [(kind, ticket, a, b)] of the admissions."""
    made = []
    for kind, a, b, to in script:
        if kind == "source":
            made.append((kind, fe.submit_source(a, timeout=to), a, b))
        elif kind == "pair":
            made.append((kind, fe.submit_pair(a, b, timeout=to), a, b))
        elif kind == "topk":
            made.append((kind, fe.submit_topk(a, b, timeout=to), a, b))
        elif kind == "advance":
            clk.advance(a)
        else:
            fe.flush()
    clk.advance(MAX_WAIT)
    fe.flush()
    return made


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_any_interleaving_bit_identical_to_direct_engine(seed, port150):
    """A random interleaving of admissions, advances and flushes gives
    answers bit-identical to a direct engine's: batching policy is
    invisible in the answers."""
    clk = VirtualClock()
    fe = make_frontend(*port150, clk)
    ref = direct(*port150)
    made = _play(fe, clk, _script(seed, port150[0].n))
    assert fe.stats()["shed"] == 0           # no deadlines in this test
    for kind, ticket, a, b in made:
        assert ticket.done()
        got = ticket.result()
        if kind == "source":
            assert np.array_equal(got, ref.single_source([a])[0])
        elif kind == "pair":
            assert got == ref.pair(a, b)
        else:
            sv, si = got
            rv, ri = ref.topk([a], b)
            assert np.array_equal(sv, rv[0]) and np.array_equal(si, ri[0])
    fe.close()


def test_zero_recompiles_after_warmup(port150):
    """No traffic pattern through admission and batching may grow the
    union of the replicas' dispatch shapes after warmup."""
    clk = VirtualClock()
    fe = make_frontend(*port150, clk)
    fe.warmup()
    before = set(map(tuple, fe.stats()["unique_shapes"]))
    n = port150[0].n
    rng = np.random.default_rng(3)
    for _ in range(40):
        fe.submit_source(int(rng.integers(n)))
        fe.submit_pair(int(rng.integers(n)), 0)
        fe.submit_topk(int(rng.integers(n)), 9)
        clk.advance(float(rng.uniform(0, MAX_WAIT)))
    clk.advance(MAX_WAIT)
    fe.flush()
    after = set(map(tuple, fe.stats()["unique_shapes"]))
    assert after == before, after - before
    fe.close()


# ----------------------------------------------------------------------
# deadlines: shed, not served
# ----------------------------------------------------------------------
def test_expired_request_is_shed_at_its_exact_deadline(port150):
    clk = VirtualClock()
    fe = make_frontend(*port150, clk)
    t = fe.submit_source(5, timeout=MAX_WAIT / 4)    # expires pre-close
    clk.advance(MAX_WAIT)
    assert t.shed
    assert t.fulfil_t == pytest.approx(MAX_WAIT / 4)
    with pytest.raises(ShedError):
        t.result()
    assert len(fe.batch_log) == 0
    assert fe.stats()["served"] == 0
    assert fe.stats()["shed"] == 1
    fe.close()


def test_expired_member_shed_without_poisoning_batchmates(port150):
    clk = VirtualClock()
    fe = make_frontend(*port150, clk)
    ref = direct(*port150)
    t_live = fe.submit_source(1)
    t_dead = fe.submit_source(2, timeout=MAX_WAIT / 2)
    clk.advance(MAX_WAIT)
    assert t_dead.shed and not t_live.shed
    assert np.array_equal(t_live.result(), ref.single_source([1])[0])
    assert fe.batch_log[-1].size == 1
    fe.close()


def test_nonpositive_timeout_sheds_at_admission(port150):
    clk = VirtualClock()
    fe = make_frontend(*port150, clk)
    t = fe.submit_source(1, timeout=0.0)
    assert t.shed and t.done()
    st = fe.stats()
    assert st["admitted"] == 1 and st["shed"] == 1 and st["pending"] == 0
    fe.close()


def test_default_timeout_applies_when_request_has_none(port150):
    clk = VirtualClock()
    fe = make_frontend(*port150, clk, default_timeout=MAX_WAIT / 2)
    t = fe.submit_source(4)
    clk.advance(MAX_WAIT)
    assert t.shed
    fe.close()


# ----------------------------------------------------------------------
# hot-swap: the epoch barrier
# ----------------------------------------------------------------------
def test_swap_never_produces_a_mixed_epoch_batch(stale150):
    """Mid-traffic swap_index: requests admitted before the barrier serve
    bit-identically from the OLD index, requests after from the NEW one,
    and the batch log shows monotone, pure epochs."""
    make, g = stale150
    idx = make()
    clk = VirtualClock()
    fe = make_frontend(idx, g, clk, replicas=2, routing="round_robin")
    ref = direct(idx, g)
    e0 = fe.stats()["epoch"]

    pre_us = [3, 8, 11]
    pre = [fe.submit_source(u) for u in pre_us]
    clk.advance(MAX_WAIT)                    # first batch serves now
    open_t = fe.submit_source(42)            # left OPEN at swap time
    # reference answers captured BEFORE update_index repairs in place
    expect_pre = {u: ref.single_source([u])[0].copy()
                  for u in pre_us + [42]}

    delta = tupdate.random_delta(g, n_add=6, n_del=6, seed=5)
    rep = tbuild.update_index(idx, g, delta, seed=1)
    res = fe.swap_index(idx, rep.graph, affected=rep.affected)
    e1 = res["epoch"]
    assert e1 == e0 + 1
    assert res["recompiles"] == 0            # capacity buckets held
    assert res["replicas"] == 2 and res["barrier_batches"] == 1

    assert open_t.done()
    assert np.array_equal(open_t.result(), expect_pre[42])
    for u, t in zip(pre_us, pre):
        assert np.array_equal(t.result(), expect_pre[u])

    ref.swap_index(idx, rep.graph, affected=rep.affected)
    post = [fe.submit_source(u) for u in pre_us]
    clk.advance(MAX_WAIT)
    for u, t in zip(pre_us, post):
        assert np.array_equal(t.result(), ref.single_source([u])[0])

    epochs = [r.epoch for r in fe.batch_log]
    assert set(epochs) <= {e0, e1}
    assert epochs == sorted(epochs), f"mixed/reordered epochs: {epochs}"
    swap_recs = [r for r in fe.batch_log if r.reason == "swap"]
    assert swap_recs and all(r.epoch == e0 for r in swap_recs)
    fe.close()


def test_requests_admitted_during_barrier_wait_for_new_epoch(stale150):
    make, g = stale150
    idx = make()
    clk = VirtualClock()
    fe = make_frontend(idx, g, clk)
    e0 = fe.stats()["epoch"]
    t = fe.submit_source(9)                  # open batch, window armed
    delta = tupdate.random_delta(g, n_add=4, n_del=4, seed=2)
    rep = tbuild.update_index(idx, g, delta, seed=1)
    fe.swap_index(idx, rep.graph, affected=rep.affected)
    assert t.done()
    assert fe.batch_log[-1].epoch == e0
    t2 = fe.submit_source(9)
    clk.advance(MAX_WAIT)
    assert fe.batch_log[-1].epoch == e0 + 1
    ref = direct(idx, rep.graph)
    assert np.array_equal(t2.result(), ref.single_source([9])[0])
    fe.close()


# ----------------------------------------------------------------------
# skewed traffic: the cache counters through the frontend
# ----------------------------------------------------------------------
def _src_hit_rate(index, g, s: float) -> float:
    clk = VirtualClock()
    fe = make_frontend(index, g, clk, replicas=1,
                       engine=EngineConfig(pair_batch=8, source_batch=4,
                                           cache_size=16))
    for u in zipf_nodes(g.n, 300, s=s, seed=11):
        fe.submit_source(int(u))
        clk.advance(MAX_WAIT / 8)
    clk.advance(MAX_WAIT)
    fe.flush()
    st = fe.stats()
    hits = st["cache_hits_by_kind"].get("src", 0)
    misses = st["cache_misses_by_kind"].get("src", 0)
    assert hits + misses == 300              # every request consulted it
    fe.close()
    return hits / (hits + misses)


def test_cache_hit_rate_rises_with_zipf_skew(port150):
    rates = [_src_hit_rate(*port150, s) for s in (0.0, 0.8, 1.6)]
    assert rates[1] >= rates[0]
    assert rates[2] > rates[0] + 0.15, rates


def test_per_replica_stats_aggregate_through_frontend(port150):
    clk = VirtualClock()
    fe = make_frontend(*port150, clk, replicas=3, routing="round_robin")
    rng = np.random.default_rng(0)
    for u in rng.integers(0, port150[0].n, 48):
        fe.submit_source(int(u))
    clk.advance(MAX_WAIT)
    fe.flush()
    st = fe.stats()
    reps = st["per_replica"]
    assert len(reps) == 3
    assert all(r["batches"] > 0 for r in reps)
    assert st["cache_hits"] == sum(r["cache_hits"] for r in reps)
    assert st["cache_misses"] == sum(r["cache_misses"] for r in reps)
    for kind in set().union(*(r["cache_hits_by_kind"] for r in reps)):
        assert st["cache_hits_by_kind"][kind] == sum(
            r["cache_hits_by_kind"].get(kind, 0) for r in reps)
    assert st["served"] == sum(r["source"] for r in reps) == 48
    assert all(r["device"] == "cpu" for r in reps)
    fe.close()


# ----------------------------------------------------------------------
# production dispatch (real clock, worker threads), bounded by the
# conftest deadline guard; blocking waits only, still no sleeps
# ----------------------------------------------------------------------
@pytest.mark.deadline(90)
def test_worker_failure_sheds_and_counts_the_batch(port150, capsys):
    """A batch whose engine call raises on a worker thread is shed, the
    worker stays alive, and ``stats()["failed"]`` counts its tickets
    apart from the deadline sheds (a caller can fail on it)."""
    fe = ServeFrontend(*port150, FrontendConfig(max_batch=4, max_wait=0.002,
                                                replicas=1, engine=ECFG),
                       device="cpu")

    def refused(us):
        raise RuntimeError("launch refused")

    fe.engines[0].single_source = refused
    bad = [fe.submit_source(u, timeout=60.0) for u in range(4)]
    fe.drain(timeout=60.0)
    assert all(t.shed for t in bad)
    good = fe.submit_pair(1, 2, timeout=60.0)
    fe.flush()
    fe.drain(timeout=60.0)
    assert not good.shed
    st = fe.stats()
    assert (st["failed"], st["shed"], st["served"]) == (4, 4, 1)
    assert "launch refused" in capsys.readouterr().err
    fe.close()


@pytest.mark.deadline(90)
def test_thread_dispatch_end_to_end(port150):
    fe = ServeFrontend(*port150, FrontendConfig(max_batch=4, max_wait=0.002,
                                                replicas=2, engine=ECFG),
                       device="cpu")
    assert fe.stats()["dispatch"] == "thread"
    ref = direct(*port150)
    us = zipf_nodes(port150[0].n, 24, s=1.1, seed=0)
    tickets = [fe.submit_source(int(u), timeout=60.0) for u in us]
    fe.flush()
    fe.drain(timeout=60.0)
    for u, t in zip(us, tickets):
        assert np.array_equal(t.result(timeout=10.0),
                              ref.single_source([int(u)])[0])
    assert fe.stats()["shed"] == 0
    fe.close()
    assert not any(th.is_alive() for th in fe._workers)


@pytest.mark.deadline(90)
def test_thread_dispatch_under_contention(port150):
    """More replica workers than cores, a 1 us switch interval and three
    kinds at once: every admitted request is served exactly once, the
    counts add up across the workers, and every answer equals a direct
    engine's bits (a lost update or a torn batch would break one)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        replicas = 12
        fe = ServeFrontend(*port150, FrontendConfig(
            max_batch=2, max_pair_batch=3, max_wait=0.001,
            replicas=replicas, routing="round_robin", engine=ECFG),
            device="cpu")
        n = port150[0].n
        us = zipf_nodes(n, 90, s=1.1, seed=4)
        vs = zipf_nodes(n, 90, s=1.1, seed=5)
        tickets = []
        for i, (u, v) in enumerate(zip(us.tolist(), vs.tolist())):
            kind = ("source", "pair", "topk")[i % 3]
            t = (fe.submit_source(u, timeout=60.0) if kind == "source"
                 else fe.submit_pair(u, v, timeout=60.0) if kind == "pair"
                 else fe.submit_topk(u, 3, timeout=60.0))
            tickets.append((kind, t, u, v))
        fe.flush()
        fe.drain(timeout=60.0)
        st = fe.stats()
        fe.close()
    finally:
        sys.setswitchinterval(old)
    assert st["admitted"] == st["served"] == 90 and st["shed"] == 0
    assert st["inflight"] == 0 and st["pending"] == 0
    assert sum(r.size for r in fe.batch_log) == 90
    assert sum(r["pair"] + r["source"] + r["topk"]
               for r in st["per_replica"]) == 90
    ref = direct(*port150, EngineConfig(pair_batch=8, source_batch=4,
                                        cache_size=0, k_buckets=(4, 16)))
    for kind, t, u, v in tickets:
        got = t.result(timeout=10.0)
        if kind == "source":
            assert np.array_equal(got, ref.single_source([u])[0])
        elif kind == "pair":
            assert got == ref.pair(u, v)
        else:
            rv, ri = ref.topk([u], 3)
            assert np.array_equal(got[0], rv[0])
            assert np.array_equal(got[1], ri[0])


def test_virtual_clock_refuses_thread_dispatch(port150):
    with pytest.raises(ValueError, match="inline-only"):
        ServeFrontend(*port150, FrontendConfig(dispatch="thread",
                                               engine=ECFG),
                      clock=VirtualClock(), device="cpu")


def test_from_index_file_shares_one_mapped_artifact(tmp_path, port150):
    path = str(tmp_path / "i.sling")
    port150[0].save(path)
    clk = VirtualClock()
    fe = ServeFrontend.from_index_file(
        path, port150[1], FrontendConfig(replicas=2, max_wait=MAX_WAIT,
                                         engine=ECFG),
        clock=clk, mmap=True, device="cpu")
    idx = fe.engines[0].index
    assert idx.read_only and all(e.index is idx for e in fe.engines)
    t = fe.submit_topk(7, 9)
    clk.advance(MAX_WAIT)
    rv, ri = direct(*port150).topk([7], 9)
    assert np.array_equal(t.result()[0], rv[0])
    assert np.array_equal(t.result()[1], ri[0])
    with fe:
        pass
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit_source(1)


# ----------------------------------------------------------------------
# differential: the reference's frontend and the port's, same script
# ----------------------------------------------------------------------
def _answers_close(kind, a, b) -> None:
    if kind == "pair":
        assert abs(a - b) <= ATOL
    elif kind == "source":
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(a[0], b[0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 5])
def test_batch_log_equals_reference_under_virtual_clock(seed, small_graph):
    """The same admissions (with deadlines, so some shed), advances,
    flushes and a barrier swap go into the reference's frontend over
    JAX engines and the port's over the carried index: equal batch
    logs field by field (kind, key, size, cap, epoch, replica, reason,
    opened, closed), the same shed tickets, answers within
    BACKEND_ATOL."""
    g = small_graph
    ri = rbuild.build_index(g, eps=0.1, exact_d=True, seed=0,
                            stale_frac=0.3)
    ti, tg = _carry(ri, g)
    over = dict(max_batch=3, max_pair_batch=4, max_wait=MAX_WAIT,
                replicas=2, routing="least_loaded")
    rclk, tclk = RVirtualClock(), VirtualClock()
    rfe = RServeFrontend(ri, g, RFrontendConfig(engine=RECFG, **over),
                         clock=rclk)
    tfe = ServeFrontend(ti, tg, FrontendConfig(engine=ECFG, **over),
                        clock=tclk, device="cpu")
    script = _script(seed, g.n, steps=50, timeouts=True)
    rmade = _play(rfe, rclk, script[:25])
    tmade = _play(tfe, tclk, script[:25])
    # one barrier swap through both, on the same edge delta; each package
    # repairs a copy (the reference's CPU engines may alias the index's
    # arrays, and the held requests must see the old epoch's)
    ri2, ti2 = copy.deepcopy(ri), copy.deepcopy(ti)
    rdelta = rupdate.random_delta(g, n_add=5, n_del=5, seed=seed + 1)
    rrep = rbuild.update_index(ri2, g, rdelta, exact_d=True)
    tdelta = tupdate.random_delta(tg, n_add=5, n_del=5, seed=seed + 1)
    for f in ("add_src", "add_dst", "del_src", "del_dst"):
        np.testing.assert_array_equal(getattr(tdelta, f),
                                      getattr(rdelta, f))
    trep = tbuild.update_index(ti2, tg, tdelta, exact_d=True)
    held = [(k, rfe.submit_source(u), tfe.submit_source(u), u)
            for k, u in (("source", 3), ("source", 11))]
    rsw = rfe.swap_index(ri2, rrep.graph, affected=rrep.affected)
    tsw = tfe.swap_index(ti2, trep.graph, affected=trep.affected)
    assert (tsw["epoch"], tsw["barrier_batches"], tsw["recompiles"]) == \
        (rsw["epoch"], rsw["barrier_batches"], rsw["recompiles"])
    rmade += _play(rfe, rclk, script[25:])
    tmade += _play(tfe, tclk, script[25:])
    rlog, tlog = list(rfe.batch_log), list(tfe.batch_log)
    assert len(tlog) == len(rlog) > 10
    for r, t in zip(rlog, tlog):
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
    rst, tst = rfe.stats(), tfe.stats()
    for k in ("admitted", "shed", "served", "batches", "swaps", "epoch"):
        assert tst[k] == rst[k], k
    assert tst["mean_occupancy"] == rst["mean_occupancy"]
    assert 0 < rst["shed"] < rst["admitted"]
    assert len(rmade) == len(tmade)
    for (kind, rt, a, _), (_, tt, _, _) in zip(rmade, tmade):
        assert tt.shed == rt.shed and tt.fulfil_t == rt.fulfil_t
        if not rt.shed:
            _answers_close(kind, tt.result(), rt.result())
    for kind, rt, tt, _ in held:
        _answers_close(kind, tt.result(), rt.result())
    rfe.close()
    tfe.close()


@pytest.mark.parametrize("n,size,s,seed", [(150, 300, 1.1, 0),
                                           (36692, 2000, 1.1, 0),
                                           (64, 50, 0.0, 3),
                                           (1000, 500, 1.6, 11)])
def test_zipf_load_equals_reference(n, size, s, seed):
    np.testing.assert_array_equal(zipf_weights(n, s), rzipf_weights(n, s))
    got = zipf_nodes(n, size, s=s, seed=seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, rzipf_nodes(n, size, s=s,
                                                   seed=seed))
    with pytest.raises(ValueError, match="n must be"):
        zipf_weights(0, s)
