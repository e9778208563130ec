#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SLING on one NVIDIA card.

    python3 chip_smoke.py                  # the paper's Enron regime
    python3 chip_smoke.py --graph GrQc     # a smaller Table-3 regime

Phases (any failure raises and the script exits non-zero):

  1. device: a CUDA card is required; prints its name and power limit;
  2. build the hand-written kernels from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, in parallel);
  3. the port's main path at real size, through the entry points a user
     calls: ``build_index`` (Alg-4 walk diagonal + dense Alg-2 table on
     the card) at the paper's eps = 0.025, c = 0.6, then ``QueryEngine``
     ``warmup`` and pair, single-source and top-k (k = 10) batches. The
     kernels' launch counters are zeroed just before and read just
     after; both kernels must have launched, the dispatch shape set must
     not grow after warmup, and sampled answers must match an engine on
     the plain backends on the card;
  3b. the dynamic-graph path at real size: an index built with
     stale_frac = 0.2 behind a warm engine takes two random churn
     batches (0.1 % and 1 % of m) through ``update_index`` on the card,
     each hot-swapped in with ``swap_index`` and served; the repaired
     rows R are checked against a from-scratch rebuild of the mutated
     graph on every target in K. The counters are zeroed before and
     read after the batches; ``spmm`` must launch in both 3 and 3b;
  3c. xDeepFM serving at full width (``xdeepfm.full()``, 432,742,000
     parameters from a seeded ``torch.Generator``): serve_p99 (22
     ``RecsysStream`` batches of 512 through ``recsys_serve_step``, per
     batch p50/p99 from CUDA events), retrieval_cand (one user against
     1,000,000 candidates through ``recsys_retrieval_step``, top-128),
     then the SLING prior: a 40,000-node user-item click graph indexed
     on the card, ``single_source_device`` for 8 users and retrieval
     over its 30,000 items with ``sim_prior``. The counters are zeroed
     before and read after; ``cin``, ``horner_push`` and ``spmm`` must
     all launch. Checks (outside the counts): logits against the plain
     CIN on the card, top-128 against a stable sort, fused - base =
     sim_w * prior;
  3d. the index artifact at the Enron regime, in a temporary directory
     under ``build/`` that is removed after: phase 3's float32 index is
     saved as v3 (bytes and seconds printed), loaded eagerly onto the
     card and mapped (``mmap=True``), and served from the mapped file
     through ``QueryEngine.from_index_file`` (install ms); the sample
     must equal phase 3's answers bit for bit. A v2 ``.npz`` round
     trip follows. Then, with the counters zeroed: ``build_index(
     quant_frac=0.2)`` on the card, ``quantize_index(int16)``, a v3
     save, the mapped file served; ``hp_join``, ``horner_push`` and
     ``spmm`` must launch, and the answers must lie within
     ``quant_charge`` of the same plan's float32 index on the card, the
     float payload at most 0.6x, and ``quantize_index(bf16)`` must be
     refused at this plan. Last, ``build_index(space_reduce=True,
     enhance=True)``: rows reduced, bytes saved, a v3 round trip of the
     ``reduced`` and ``marks`` members, ``QueryEngine``'s refusal, and
     64 ``query_pair_host(u, v, g)`` answers beside the unreduced
     index's;
  3e. the scale path at 10^6 nodes (the reference's run_scale setting,
     ``benchmarks/bench_space.py:148``), in a temporary directory under
     ``build/``: ``powerlaw_fast(10^6, k=6, seed=0)``, then
     ``build_index_scale(eps=0.5, quant_frac=0.2, int16)`` on the card
     with ``builder="auto"`` (it must pick prsim, with the chunked
     certified diagonal) and again with ``builder="sling"`` (the two
     files must be equal byte for byte outside the header's builder);
     the prsim file loaded mapped and served by two
     ``from_index_file(mmap=True)`` engines: single-source and top-k
     batches of 2 and 8 (the graph's hub among the sources) and 64
     pairs. The counters are zeroed before the first build and read
     after the last batch; ``hp_join`` and ``horner_push`` must launch.
     Then, outside the counts, every answer against an engine on the
     plain backends on the card (BACKEND_ATOL); the build, load and
     install times, entries, width, bytes, the peak host RSS of the
     phase (statm sampled) and of the process, and the peak device
     memory are printed. Last, the
     build options on phase 3's graph: ``build_hp_table`` with
     ``spill_dir`` and a width 64 above the table's, equal to phase 3's
     table with the extra columns PAD; ``spmm`` must launch. With
     ``--profile``, four hub batches and four tail blocks of the sparse
     build are traced;
  4. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and on its rows: max abs error, times (CUDA
     events), the card's bound and a library call's time where one
     exists (``hp_join`` at B = 256 pairs by the profiler's device time,
     with two calls held to equal bits and ``launch_floor_ms``, a
     one-element ``add_``, beside it; ``horner_push`` at B = 8 and 16
     on the Enron engine and at B = 2 and 8 on phase 3e's 10^6 engine:
     the whole push from the row ids on the card to the (B, n) result,
     the kernel's device time, the allocations before its one launch,
     the levels it runs, two pushes held to equal bits, the bound
     (inputs read once, the result written once) and the bytes streamed
     through the levels run, ``torch.sparse.mm`` over all l_max + 1
     levels, and the kernel's time on cut inputs -- no edges, level-0
     keys only -- to split it per level;
     ``spmm`` on every step of one build block and of one push
     mass-scan block, as the path calls it, with the prune threshold and
     the live-segment masks: equal bits to the dense kernel, live_out
     equal to ``segment_live``; timed on the step-3 frontiers masked,
     dense and through ``torch.sparse.mm``, and as each block's mean per
     launch, beside the bound of what the frontier needs and the dense
     bound; ``cin`` at the serve_p99 shapes, on the model's own
     embeddings and on O(1)-scale inputs, relative to max |out|, with
     two calls held to equal bits, its 3xTF32 tensor-core bound and the
     float32-FMA bound beside it, then timed at retrieval_cand's
     shapes);
  5. accuracy: on a 64-node graph built with the exact diagonal, every
     pair, single-source and top-k answer is within eps + 1e-5 of exact
     SimRank (power method), for the float32 index, an int16 index
     (quant_frac 0.25) and a bf16 index (eps 0.2, quant_frac 0.8, d in
     float32), each mapped from a v3 file and served on the card; and
     every host pair of the reduced, enhanced index;
  6. output: a ``{"kernels": [...]}`` line, the card's name and power
     limit, and last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): memory
# bandwidth, non-tensor-core float32 rate and dense TF32 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 494.7e12
TOL_KERNEL = 1e-5      # kernel vs plain version, float32 reduction order
EPS = 0.025            # the paper's Section-7.1 eps (c = 0.6)
BLOCK = 256            # target columns per Alg-2 frontier block
STALE_FRAC = 0.2       # eps share reserved for updates (bench_update.py)
CHURN = (0.001, 0.01)  # edges per update batch, as fractions of m
TOL_CIN = 2e-5         # CIN vs plain, relative to max |out| (float32 order)
TOL_PRIOR = 1e-5       # fused - base vs sim_w * prior (test_system.py:124)
SERVE_STEPS = (2, 20)  # serve_p99: warm-up batches, timed batches
N_CAND = 1_000_000     # retrieval_cand (launch/specs.py RECSYS_SHAPE_DEFS)
N_CHECK = 4_096        # candidates recomputed on the plain CIN
CLICK_GRAPH = (10_000, 30_000, 150_000)   # users, items, clicks
N_PRIOR_USERS = 8
QUANT_FRAC = 0.2       # eps share reserved for quantization (phase 3d)
N_SCALE = 1_000_000    # phase 3e: benchmarks/bench_space.py:148 run_scale
SCALE_EPS = 0.5        # its eps: the packed width stays ~64
# a kernel row's keys beyond the contract's, printed beside it
ROW_EXTRAS = ("call_ms", "launch_floor_ms", "launch_floor_device_ms",
              "steps", "levels_run", "push_ms", "alloc_ms",
              "streamed_bound_ms", "b16", "parts")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back
    calls (CUDA events, after one warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float,
             rate: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pct(lat_s: list[float]) -> str:
    import numpy as np
    a = 1e3 * np.asarray(lat_s)
    return (f"p50 {np.percentile(a, 50):.3f} ms p99 "
            f"{np.percentile(a, 99):.3f} ms")


def trace(label: str, fn) -> None:
    """Run ``fn`` under torch.profiler and print the device's busy share
    of the window (the device time of kernels and copies over the wall
    time) and the top rows by device and by CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # device-side rows only (kernels, copies, memsets), as the table's
    # own "Self CUDA time total"; an aten op's row repeats its kernels
    dev = sum(r.self_device_time_total for r in rows
              if r.device_type == DeviceType.CUDA
              and not getattr(r, "is_user_annotation", False)) / 1e6
    print(f"[profile] {label}: wall {wall * 1e3:.3f} ms, device busy "
          f"{dev * 1e3:.3f} ms ({100 * dev / wall:.1f}%)")
    for sort_by in ("self_device_time_total", "cpu_time_total"):
        for line in rows.table(sort_by=sort_by, row_limit=15).splitlines():
            print(f"[profile] {line}")


def profile_serving(eng, q) -> None:
    """Trace 4 pair, 4 single-source and 4 top-k batches (fresh nodes,
    so no cache hits)."""
    def run():
        for lo in range(0, 32, 8):
            eng.pairs(q[lo:lo + 8], q[lo + 32:lo + 40])
            eng.single_source(q[lo:lo + 8])
            eng.topk(q[lo + 32:lo + 40], 10)
    trace("12 batches", run)


def table_rows_vs_fresh(hp, fresh, rows, targets, theta: float) -> dict:
    """Hold the rows ``rows`` of a repaired table, restricted to entries
    whose target is in ``targets``, against a fresh table: keys must be
    equal and values within TOL_KERNEL; an entry on one side only is
    allowed (and counted) only within float32 rounding of theta."""
    import torch
    dev = hp.keys.device
    n = hp.n
    r = torch.as_tensor(rows, device=dev)
    tg = torch.sort(torch.as_tensor(targets, device=dev)).values

    def coo(t):
        k, v = t.keys[r], t.vals[r]
        live = (torch.arange(t.width, device=dev)[None, :]
                < t.counts[r].long()[:, None])
        ri, ci = torch.nonzero(live & torch.isin(k.long() % n, tg),
                               as_tuple=True)
        code = r[ri] * (1 << 31) + k[ri, ci].long()
        order = torch.argsort(code)
        return code[order], v[ri, ci][order]

    ca, va = coo(hp)
    cb, vb = coo(fresh)
    in_b, in_a = torch.isin(ca, cb), torch.isin(cb, ca)
    only = torch.cat([va[~in_b], vb[~in_a]])
    near = (only - theta).abs() <= 4e-7 * theta
    shared_err = float((va[in_b] - vb[in_a]).abs().max()) if \
        int(in_b.sum()) else 0.0
    return {"entries": len(ca), "fresh_entries": len(cb),
            "one_side_only": len(only), "at_theta": int(near.sum()),
            "max_abs_err": shared_err,
            "bit_equal": bool(len(only) == 0 and torch.equal(va, vb)),
            "ok": bool(near.all()) and shared_err <= TOL_KERNEL}


class _Clock:
    """Per-call milliseconds: CUDA events on the card, the host clock
    (after the call returns) on the CPU, where the phase is rehearsed."""

    def __init__(self, dev):
        import torch
        self.cuda = dev.type == "cuda"
        self.torch = torch

    def __call__(self, fn):
        if not self.cuda:
            t = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t) * 1e3
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def xdeepfm_phase(dev, cfg=None, n_cand: int = N_CAND,
                  click_graph=CLICK_GRAPH, eps: float = EPS,
                  profile: bool = False):
    """xDeepFM serving on ``dev``: serve_p99, retrieval_cand and the
    SimRank-prior retrieval (see the module docstring, phase 3c); with
    ``profile``, a trace of 4 more serve batches and of one more
    retrieval after the path's counts are read.
    Returns (the model, a serve batch, the launches of the path)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import xdeepfm
    from repro_torch.core import build
    from repro_torch.core.single_source import single_source_device
    from repro_torch.core.topk import stable_topk
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.device import synchronize
    from repro_torch.graph import generators
    from repro_torch.kernels.cin import cin_layer
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.spmv_ell import HEAVY_DEGREE, spmm
    from repro_torch.launch.specs import RECSYS_SHAPE_DEFS, \
        recsys_model_flops
    from repro_torch.models import recsys
    from repro_torch.train.steps import recsys_retrieval_step, \
        recsys_serve_step

    kernels = {"cin": cin_layer, "horner_push": horner_push_rows,
               "spmm": spmm}
    path = {k: 0 for k in kernels}
    path["horner_push_steps"] = 0

    def zero():
        for kern in kernels.values():
            kern.launches = 0
        horner_push_rows.steps = 0

    def read():
        for k, kern in kernels.items():
            path[k] += kern.launches
        path["horner_push_steps"] += horner_push_rows.steps

    clock = _Clock(dev)
    cfg = cfg or xdeepfm.full()
    prior_cfg = dataclasses.replace(cfg, sim_prior=True)
    t0 = time.perf_counter()
    # one module for both configs: sim_prior adds the scalar sim_w
    model = recsys.XDeepFM(prior_cfg, generator=torch.Generator(
        device=dev).manual_seed(0))
    synchronize(dev)
    numel = sum(p.numel() for p in model.parameters())
    table_bytes = sum(p.numel() * p.element_size()
                      for p in model.tables.values())
    print(f"[xdeepfm] {cfg.name}: param_count={cfg.param_count():,} "
          f"(the module holds {numel:,}: + the scalars bias and sim_w, "
          f"which param_count leaves out, as the reference does); tables "
          f"{table_bytes / 1e9:.3f} GB; init {time.perf_counter() - t0:.2f}s")
    if numel != cfg.param_count() + 2:
        raise RuntimeError("the module's parameters differ from "
                           "param_count")

    # ---- serve_p99 ----
    B = RECSYS_SHAPE_DEFS["serve_p99"]["batch"]
    stream = RecsysStream(cfg.n_fields, cfg.vocab_per_field, B,
                          multi_hot_fields=cfg.multi_hot_fields,
                          bag_size=cfg.bag_size)
    batches = [stream.batch_at(s) for s in range(sum(SERVE_STEPS))]
    serve = recsys_serve_step(cfg)
    zero()
    probs, lat = [], []
    for b in batches:
        p, ms = clock(lambda: serve(model, b))
        probs.append(p)
        lat.append(ms / 1e3)
    read()
    lat = lat[SERVE_STEPS[0]:]
    flops = recsys_model_flops(cfg, B, train=False)
    print(f"[xdeepfm] serve_p99: {len(lat)} batches of {B} (after "
          f"{SERVE_STEPS[0]} warm-up): per batch {pct(lat)} (CUDA events); "
          f"{flops / 1e9:.2f} GFLOP per batch")
    allp = torch.stack(probs)
    if not bool(torch.isfinite(allp).all()) or \
            float(allp.min()) < 0.0 or float(allp.max()) > 1.0:
        raise RuntimeError("serve probabilities not finite in [0, 1]")
    with torch.inference_mode():                      # check, not counted
        lk = recsys.forward(cfg, model, batches[0])
        lp = recsys.forward(cfg, model, batches[0], backend="plain")
    e_serve = rel_err(lk, lp)
    print(f"[xdeepfm] serve step 0 logits vs the plain CIN on the card: "
          f"{e_serve:.3g} of max |logit| = {float(lp.abs().max()):.4g} "
          f"(bound {TOL_CIN})")
    if not e_serve <= TOL_CIN:
        raise RuntimeError(f"serve logits disagree with plain: {e_serve}")
    if profile:
        trace(f"4 serve_p99 batches of {B}",
              lambda: [serve(model, b) for b in batches[:4]])

    # ---- retrieval_cand ----
    rng = np.random.default_rng(0)
    n_item = cfg.n_fields - cfg.n_user_fields
    rb = {"user_ids": torch.as_tensor(
              rng.integers(0, cfg.vocab_per_field, cfg.n_user_fields),
              device=dev),
          "cand_ids": torch.as_tensor(
              rng.integers(0, cfg.vocab_per_field, (n_cand, n_item)),
              device=dev)}
    retrieve = recsys_retrieval_step(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero()
    out = retrieve(model, rb)                         # warm
    secs = []
    for _ in range(3):
        del out
        t = time.perf_counter()
        out = retrieve(model, rb)
        synchronize(dev)
        secs.append(time.perf_counter() - t)
    read()
    peak = torch.cuda.max_memory_allocated() / 2**30 \
        if dev.type == "cuda" else float("nan")
    flops = recsys_model_flops(cfg, n_cand, train=False)
    print(f"[xdeepfm] retrieval_cand: C={n_cand:,} top-128: "
          + " ".join(f"{x:.3f}s" for x in secs)
          + f" (3 reps after one warm); {flops / 1e12:.2f} TFLOP, "
          f"{flops / min(secs) / 1e12:.2f} TFLOP/s at the best rep; "
          f"peak device memory {peak:.2f} GiB (candidate ids on the card)")
    scores = out["scores"]
    sv, si = stable_topk(scores[None], 128)
    if not torch.equal(out["top_i"], si[0]) or \
            not torch.equal(out["top_v"], sv[0]) or \
            not bool(torch.isfinite(scores).all()):
        raise RuntimeError("retrieval top-128 is not the stable top-128")
    with torch.inference_mode():                      # check, not counted
        sub = {"user_ids": rb["user_ids"],
               "cand_ids": rb["cand_ids"][:N_CHECK]}
        sp = recsys.score_candidates(cfg, model, sub, backend="plain")
    e_ret = float((scores[:N_CHECK] - sp).abs().max()
                  / sp.abs().max())
    print(f"[xdeepfm] retrieval: first {N_CHECK} scores vs the plain CIN "
          f"on the card: {e_ret:.3g} of max |score| = "
          f"{float(sp.abs().max()):.4g} (bound {TOL_CIN}); top score "
          f"{float(out['top_v'][0]):.6g} at candidate "
          f"{int(out['top_i'][0])}")
    if not e_ret <= TOL_CIN:
        raise RuntimeError(f"retrieval scores disagree with plain: {e_ret}")
    if profile:
        del out
        trace(f"one retrieval_cand step, C={n_cand:,}",
              lambda: retrieve(model, rb))
        out = None
    del out, scores, rb, sub, sp

    # ---- the SLING SimRank prior over a click graph ----
    n_users, n_items, clicks = click_graph
    g = generators.bipartite(n_users, n_items, clicks, seed=0)
    zero()
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=eps, c=0.6, seed=0, block=BLOCK,
                            device=dev)
    t_build = time.perf_counter() - t0
    clicked_any = np.flatnonzero(g.in_deg[:n_users] > 0)
    users = np.sort(rng.choice(clicked_any, N_PRIOR_USERS, replace=False))
    # a user and an item never meet on a bipartite graph (their reverse
    # walks are on opposite sides at every step), so a user's SimRank to
    # every item is 0; an item each user clicked is a second source,
    # whose item-to-item scores are the prior that is not zero
    items = np.array([rng.choice(g.in_neighbors(u)) for u in users])
    sources = np.concatenate([users, items])
    t0 = time.perf_counter()
    sim = single_source_device(idx, g, sources, device=dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = single_source_device(idx, g, sources, device=dev)
    t_warm = time.perf_counter() - t0
    item_ids = torch.as_tensor(rng.integers(0, cfg.vocab_per_field,
                                            (n_items, n_item)), device=dev)
    fused_step = recsys_retrieval_step(prior_cfg)
    base, fused, lat = [], [], []
    for u in range(len(users)):
        ub = {"user_ids": torch.as_tensor(rng.integers(
                  0, cfg.vocab_per_field, cfg.n_user_fields), device=dev),
              "cand_ids": item_ids}
        base.append(retrieve(model, ub)["scores"])
        for row in (u, len(users) + u):     # the user's, the item's prior
            t = time.perf_counter()
            fused.append(fused_step(model, {
                **ub, "sim_scores": torch.as_tensor(sim[row, n_users:],
                                                    device=dev)})["scores"])
            synchronize(dev)
            lat.append(time.perf_counter() - t)
    read()
    p = idx.plan
    deg = g.in_deg
    print(f"[prior] click graph bipartite{click_graph}: n={g.n} m={g.m} "
          f"max in-degree={int(deg.max())} rows of in-degree > "
          f"{HEAVY_DEGREE}: {int((deg > HEAVY_DEGREE).sum())}")
    print(f"[prior] build_index eps={p.eps} c={p.c}: l_max={p.l_max} "
          f"d={idx.build_seconds['d']:.2f}s hp={idx.build_seconds['hp']:.2f}s"
          f" total={t_build:.2f}s width={idx.hp.width}; "
          f"single_source_device({len(users)} users + their "
          f"{len(items)} clicked items) first {t_first * 1e3:.2f} ms, warm "
          f"{t_warm * 1e3:.2f} ms; fused retrieval over {n_items:,} items "
          f"per call {pct(lat)}")
    w = float(model.recsys.sim_w)
    e_prior = max(float((fused[2 * u + k] - base[u] - w * torch.as_tensor(
        sim[k * len(users) + u, n_users:], device=dev)).abs().max())
        for u in range(len(users)) for k in (0, 1))
    e_sim = float(np.abs(single_source_device(          # not counted
        idx, g, sources, backend="plain", device=dev) - sim).max())
    user_mass = np.abs(sim[:len(users), n_users:]).sum(1)
    item_mass = sim[len(users):, n_users:].sum(1)
    print(f"[prior] fused - base vs sim_w * prior: max {e_prior:.3g} "
          f"(bound {TOL_PRIOR}); single_source_device vs the plain push "
          f"on the card: {e_sim:.3g}; prior mass on the items: from each "
          f"user {user_mass.tolist()}, from each clicked item "
          f"{np.round(item_mass, 4).tolist()}")
    if not e_prior <= TOL_PRIOR or not e_sim <= TOL_KERNEL or \
            user_mass.any() or not (item_mass > 0).all():
        raise RuntimeError(f"prior retrieval is off: {e_prior}, {e_sim}, "
                           f"{user_mass}, {item_mass}")
    if min(path.values()) <= 0:
        raise RuntimeError(f"a kernel did not launch on the xDeepFM path: "
                           f"{path}")
    del idx, base, fused
    return model, batches[0], path


def cin_row(model, batch, dev, launches: int) -> dict:
    """``cin`` against its plain version at the serve_p99 shapes (the
    three layers of one batch), on the model's own embeddings and on
    O(1)-scale inputs (x0, xk unit normal, W / sqrt(h*m)): errors
    relative to max |out| (and both versions against float64), equal
    bits from two calls, times, one ``torch.einsum`` per layer (TF32
    off), and the bounds: the kernel's own, 3xTF32 operations on the
    tensor cores, and beside it float32 FMA. Then the three layers at
    retrieval_cand's shapes (N_CAND candidates, O(1) inputs), timed."""
    import torch

    from repro_torch.kernels.cin import cin_layer, cin_layer_ref
    from repro_torch.kernels.cin.cin import (split_weights,
                                             split_weights_on_card)
    from repro_torch.models import recsys

    cfg = model.cfg
    with torch.inference_mode():
        x0 = recsys.embed(cfg, model, batch)
        Ws = [w.detach() for w in model.recsys.cin_w]
        # each layer's input: the plain version's output of the layer
        # before, so kernel and plain see the same inputs
        xs = [x0]
        for W in Ws[:-1]:
            xs.append(cin_layer(x0, xs[-1], W, backend="plain"))
        gen = torch.Generator(device=dev).manual_seed(1)
        unit = [(torch.randn(x0.shape, generator=gen, device=dev),
                 torch.randn(xk.shape, generator=gen, device=dev),
                 torch.randn(W.shape, generator=gen, device=dev)
                 / math.sqrt(W.shape[1] * W.shape[2]))
                for xk, W in zip(xs, Ws)]
        errs = {"model": [], "unit": []}
        abs_err = 0.0
        for name, cases in (("model", [(x0, xk, W) for xk, W in
                                       zip(xs, Ws)]), ("unit", unit)):
            for a, xk, W in cases:
                got = cin_layer(a, xk, W)
                ref = cin_layer(a, xk, W, backend="plain")
                r64 = cin_layer_ref(a.double(), xk.double(), W.double())
                if name == "model":
                    abs_err = max(abs_err, float((got - ref).abs().max()))
                errs[name].append((rel_err(got, ref), rel_err(got, r64),
                                   rel_err(ref, r64)))
        same = all(torch.equal(cin_layer(x0, xk, W), cin_layer(x0, xk, W))
                   for xk, W in zip(xs, Ws))
        # the W split inside each call: the kernel the wrapper launches,
        # and its plain version's torch ops (equal bits)
        split_same = all(torch.equal(split_weights_on_card(W),
                                     split_weights(W)) for W in Ws)
        split_ms = time_ms(lambda: [split_weights_on_card(W) for W in Ws], 50)
        split_plain_ms = time_ms(lambda: [split_weights(W) for W in Ws], 50)
        B, m, D = x0.shape
        ops = sum(2.0 * B * D * W.shape[1] * m * W.shape[0] for W in Ws)
        nbytes = sum(4.0 * (x0.numel() + xk.numel() + W.numel()
                            + B * W.shape[0] * D) for xk, W in zip(xs, Ws))
        # three TF32 products per multiply-add on the tensor cores
        b_ms, b_by = bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S)
        fma_ms, _ = bound_ms(nbytes, ops)

        def run(backend):
            return lambda: [cin_layer(x0, xk, W, backend=backend)
                            for xk, W in zip(xs, Ws)]

        def library():
            return [torch.einsum("ihm,bhd,bmd->bid", W, xk, x0)
                    for xk, W in zip(xs, Ws)]

        e_lib = max(rel_err(y, cin_layer(x0, xk, W, backend="plain"))
                    for y, xk, W in zip(library(), xs, Ws))
        row = {"name": "cin", "route": "cuda",
               "source": "src/repro_torch/csrc/cin.cu",
               "replaces": "src/repro/kernels/cin/cin.py:37",
               "launches": launches, "max_abs_err": abs_err,
               "ms": time_ms(run("auto"), 50),
               "plain_ms": time_ms(run("plain"), 10),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(library, 10),
               "fma_bound_ms": fma_ms,
               "shape": f"B={B} m={m} D={D} layers "
                        + "-".join(str(W.shape[1]) for W in Ws)
                        + f"-{Ws[-1].shape[0]}"}
        del unit, cases
        xr = torch.randn((N_CAND, m, D), generator=gen, device=dev)
        w_unit = [torch.randn(W.shape, generator=gen, device=dev)
                  / math.sqrt(W.shape[1] * W.shape[2]) for W in Ws]

        def retrieval_layers():
            xk = xr
            for W in w_unit:
                xk = cin_layer(xr, xk, W)
            return xk

        r_ms = time_ms(retrieval_layers, 2)
        r_ops = ops / B * N_CAND
        del xr
    for name, es in errs.items():
        print(f"[kernel] cin on {name} inputs, per layer, relative to max "
              f"|out|: kernel vs plain / kernel vs float64 / plain vs "
              f"float64: " + "; ".join(" / ".join(f"{e:.3g}" for e in t)
                                       for t in es))
    print(f"[kernel] cin: the einsum library call vs plain {e_lib:.3g}; "
          f"serve_p99 {ops / 1e9:.2f} GFLOP, kernel at "
          f"{ops / row['ms'] / 1e9:.2f} TFLOP/s; bounds: 3xTF32 on the "
          f"tensor cores {b_ms:.4f} ms, float32 FMA {fma_ms:.4f} ms; two "
          f"calls give equal bits: {same}")
    print(f"[kernel] cin W split (3 layers, inside the kernel's ms): the "
          f"cin_split kernel {split_ms:.4f} ms, its plain torch ops "
          f"{split_plain_ms:.4f} ms; equal bits: {split_same}")
    print(f"[kernel] cin at retrieval_cand (C={N_CAND:,}, 3 layers, one "
          f"call each): {r_ms:.3f} ms, {r_ops / 1e12:.2f} TFLOP, kernel at "
          f"{r_ops / r_ms / 1e9:.2f} TFLOP/s")
    worst = max(t[0] for es in errs.values() for t in es)
    if not worst <= TOL_CIN:
        raise RuntimeError(f"cin disagrees with its plain version: {worst}")
    if not same:
        raise RuntimeError("two cin calls on the same inputs differ")
    if not split_same:
        raise RuntimeError("cin_split disagrees with split_weights")
    return row


def accuracy(label: str, eng, S, eps: float) -> None:
    """Every pair, single-source and top-k (k = 10) answer of ``eng``
    within eps + 1e-5 of the exact SimRank matrix ``S``."""
    import numpy as np
    n = S.shape[0]
    tol = eps + 1e-5
    uu, vv = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    acc = {"pair": float(np.abs(eng.pairs(uu.ravel(), vv.ravel())
                                .reshape(n, n) - S).max()),
           "source": float(np.abs(eng.single_source(np.arange(n))
                                  - S).max())}
    sv, si = eng.topk(np.arange(n), 10)
    acc["topk"] = float(np.abs(sv - S[np.arange(n)[:, None], si]).max())
    # a returned node's exact score is at most 2 tol below the exact
    # 10th best (both sides are within tol of exact)
    kth = np.sort(S, axis=1)[:, ::-1][:, 9]
    gap = float(max(0.0, (kth[:, None] - S[np.arange(n)[:, None], si]).max()))
    st = eng.stats()
    print(f"[accuracy] {label}: n={n} eps={eps} max |err| {acc} (bound "
          f"{tol:.6g}); top-k rank gap {gap:.3g} (bound {2 * tol:.6g}); "
          f"pair={st['pair_backend']} push={st['push_backend']} "
          f"quantized={st['quantized']}")
    if max(acc.values()) > tol or gap > 2 * tol:
        raise RuntimeError(f"{label} answers beyond eps of exact "
                           f"SimRank: {acc}")


def accuracy_phase(dev) -> None:
    """Phase 5: on a 64-node graph with the exact diagonal, the float32
    index, an int16 and a bf16 index mapped from v3 files and served by
    the engine, and the reduced, enhanced index's host pairs, each
    within its eps + 1e-5 of exact SimRank (power method)."""
    import numpy as np

    from repro_torch.baselines import power
    from repro_torch.core import build, quantize
    from repro_torch.graph import generators
    from repro_torch.serve import EngineConfig, QueryEngine

    small = generators.barabasi_albert(64, 3, seed=1, directed=False)
    S = power.all_pairs(small, c=0.6, iters=power.iterations_for(1e-9, 0.6))
    sidx = build.build_index(small, eps=EPS, c=0.6, exact_d=True,
                             device=dev)
    accuracy("float32", QueryEngine(sidx, small, EngineConfig(
        cache_size=0), device=dev), S, sidx.plan.eps)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # int16 (quant_frac 0.25) and bf16 (eps 0.2, quant_frac 0.8,
        # float32 d: vmax = 1 needs 2^-8 <= the vals bound), each through
        # a v3 file mapped and served on the card
        for scheme, eps, frac, qd in (("int16", EPS, 0.25, True),
                                      ("bf16", 0.2, 0.8, False)):
            qidx = quantize.quantize_index(build.build_index(
                small, eps=eps, c=0.6, exact_d=True, quant_frac=frac,
                device=dev), scheme, quantize_d=qd)
            f = str(Path(tmp) / f"{scheme}.sling")
            qidx.save(f)
            qeng = QueryEngine.from_index_file(
                f, small, EngineConfig(cache_size=0), mmap=True, device=dev)
            accuracy(f"{scheme} mmap", qeng, S, eps)
    ridx = build.build_index(small, eps=EPS, c=0.6, exact_d=True,
                             space_reduce=True, enhance=True, device=dev)
    n = small.n
    host = np.array([[ridx.query_pair_host(u, v, small) for v in range(n)]
                     for u in range(n)])
    e_host = float(np.abs(host - S).max())
    print(f"[accuracy] reduced + enhanced ({int(ridx.reduced.sum())} of "
          f"{n} rows reduced): query_pair_host(u, v, g) max |err| "
          f"{e_host:.3g} (bound {EPS + 1e-5:.6g})")
    if not e_host <= EPS + 1e-5:
        raise RuntimeError(f"host pairs beyond eps of exact: {e_host}")


def serve_sample(eng, pair_u, pair_v, src_q, top_q):
    """Phase 3's sample through ``eng``: pairs in batches of 64, then
    single-source and top-k (k = 10) batches of 8 in turn. Returns
    ({kind: answers per batch}, {kind: host seconds per batch})."""
    answers = {"pair": [], "source": [], "topk": []}
    lat = {"pair": [], "source": [], "topk": []}
    for lo in range(0, len(pair_u), 64):
        t = time.perf_counter()
        answers["pair"].append(eng.pairs(pair_u[lo:lo + 64],
                                         pair_v[lo:lo + 64]))
        lat["pair"].append(time.perf_counter() - t)
    for lo in range(0, len(src_q), 8):
        t = time.perf_counter()
        answers["source"].append(eng.single_source(src_q[lo:lo + 8]))
        lat["source"].append(time.perf_counter() - t)
        t = time.perf_counter()
        answers["topk"].append(eng.topk(top_q[lo:lo + 8], 10))
        lat["topk"].append(time.perf_counter() - t)
    return answers, lat


def answer_arrays(answers) -> dict:
    """{pair, source, topk, topk_ids}: each kind's answers as one array."""
    import numpy as np
    return {"pair": np.concatenate(answers["pair"]),
            "source": np.concatenate(answers["source"]),
            "topk": np.concatenate([a[0] for a in answers["topk"]]),
            "topk_ids": np.concatenate([a[1] for a in answers["topk"]])}


def answer_diff(a, b) -> dict:
    """max |a - b| of two samples' scores, kind by kind."""
    import numpy as np
    x, y = answer_arrays(a), answer_arrays(b)
    return {k: float(np.abs(x[k] - y[k]).max())
            for k in ("pair", "source", "topk")}


def artifact_phase(g, idx, answers, queries, dev, tmp) -> dict:
    """Phase 3d, the index artifact at the Enron regime (see the module
    docstring). ``idx`` and ``answers`` are phase 3's index and sample,
    ``queries`` the sample's (pair_u, pair_v, src_q, top_q); the files
    go to ``tmp``. The counters are zeroed before the quantized build and
    read after its mapped index served; that index's answers are then
    held against the same plan's float32 index on the card.
    Returns the launches of the path."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import build, quantize, theory
    from repro_torch.core.index import SlingIndex
    from repro_torch.device import synchronize
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import EngineConfig, QueryEngine

    def timed(fn):
        synchronize(dev)
        t = time.perf_counter()
        out = fn()
        synchronize(dev)
        return out, time.perf_counter() - t

    def same_tensors(a, b) -> bool:
        return all(torch.equal(x.to(dev), y.to(dev)) for x, y in (
            (a.d, b.d), (a.hp.keys, b.hp.keys), (a.hp.vals, b.hp.vals),
            (a.hp.counts, b.hp.counts)))

    ref = answer_arrays(answers)
    kv_bytes = idx.hp.keys.nbytes + idx.hp.vals.nbytes

    # ---- the float32 index of phase 3: v3 and v2 round trips ----------
    path = os.path.join(tmp, "enron.sling")
    _, t_save = timed(lambda: idx.save(path))
    eager, t_eager = timed(lambda: SlingIndex.load(path, device=dev))
    mapped, t_map = timed(lambda: SlingIndex.load(path, mmap=True))
    if not (same_tensors(eager, idx) and same_tensors(mapped, idx)
            and eager.plan == idx.plan and mapped.read_only):
        raise RuntimeError("the v3 round trip changed the index")
    del eager, mapped
    feng, t_inst = timed(lambda: QueryEngine.from_index_file(
        path, g, EngineConfig(), mmap=True, device=dev))
    feng.warmup()
    got, lat = serve_sample(feng, *queries)
    got = answer_arrays(got)
    bit_equal = {k: bool(np.array_equal(got[k], ref[k])) for k in ref}
    print(f"[artifact] v3 float32: {os.path.getsize(path):,} bytes "
          f"(keys + vals {kv_bytes:,}); save {t_save:.3f}s, load eager "
          f"on the card {t_eager:.3f}s, load mmap {t_map * 1e3:.3f} ms, "
          f"from_index_file(mmap) install {t_inst * 1e3:.1f} ms; served "
          + " ".join(f"{k} p50 {1e3 * np.median(v):.3f} ms"
                     for k, v in lat.items())
          + f"; equal bits to phase 3: {bit_equal}")
    if not all(bit_equal.values()):
        raise RuntimeError(f"the mapped artifact's answers differ from "
                           f"phase 3's: {bit_equal}")
    del feng
    os.remove(path)
    path2 = os.path.join(tmp, "enron.npz")
    _, t_save2 = timed(lambda: idx.save(path2, version=2))
    v2, t_load2 = timed(lambda: SlingIndex.load(path2, device=dev))
    print(f"[artifact] v2 .npz: {os.path.getsize(path2):,} bytes; save "
          f"{t_save2:.3f}s, load eager on the card {t_load2:.3f}s; equal: "
          f"{same_tensors(v2, idx)}")
    if not same_tensors(v2, idx):
        raise RuntimeError("the v2 round trip changed the index")
    del v2
    os.remove(path2)

    # ---- quantized: build, int16, save, map, serve --------------------
    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    for kern in kernels.values():
        kern.launches = 0
    horner_push_rows.steps = 0
    qbase, t_build = timed(lambda: build.build_index(
        g, eps=EPS, c=0.6, seed=0, block=BLOCK, quant_frac=QUANT_FRAC,
        device=dev))
    p = qbase.plan
    b_vals = theory.quant_vals_bound(p, d_channel=True)
    b_d = theory.quant_d_bound(p)
    iq, t_quant = timed(lambda: quantize.quantize_index(qbase, "int16"))
    qpath = os.path.join(tmp, "enron-int16.sling")
    _, t_qsave = timed(lambda: iq.save(qpath))
    qeng, t_qinst = timed(lambda: QueryEngine.from_index_file(
        qpath, g, EngineConfig(), mmap=True, device=dev))
    qeng.warmup()
    qans, qlat = serve_sample(qeng, *queries)
    synchronize(dev)
    path_launches = {k: kern.launches for k, kern in kernels.items()}
    path_launches["horner_push_steps"] = horner_push_rows.steps
    quantized = qeng.stats()["quantized"]
    del qeng
    # checks, outside the count: the same plan's float32 index on the card
    feng = QueryEngine(qbase, g, EngineConfig(), device=dev)
    fans, _ = serve_sample(feng, *queries)
    del feng
    diff = answer_diff(qans, fans)
    charge = theory.quant_charge(p, b_vals, b_d)
    pay_fp = qbase.hp.vals.nbytes + 4 * qbase.n
    pay_q = iq.hp.vals.nbytes + 2 * iq.n
    try:
        quantize.quantize_index(qbase, "bf16")
        bf16 = "not refused"
    except ValueError as e:
        bf16 = f"refused ({e})"
    print(f"[artifact] quant_frac={QUANT_FRAC}: eps_quant={p.eps_quant:.6g}"
          f" b_vals={b_vals:.6g} b_d={b_d:.6g} quant_charge={charge:.6g}; "
          f"build {t_build:.2f}s, quantize_index(int16) on the card "
          f"{t_quant * 1e3:.1f} ms (scale {iq.quant.scale:.6g}, d_scale "
          f"{iq.quant.d_scale:.6g}), save {t_qsave:.3f}s, "
          f"{os.path.getsize(qpath):,} bytes; from_index_file(mmap) "
          f"install with the dequantize {t_qinst * 1e3:.1f} ms; "
          f"stats quantized={quantized}")
    print(f"[artifact] int16 served: "
          + " ".join(f"{k} p50 {1e3 * np.median(v):.3f} ms"
                     for k, v in qlat.items())
          + f"; launches {path_launches}; max |int16 - float32| {diff} "
          f"(bound {charge:.6g}); float payload {pay_q:,} / {pay_fp:,} = "
          f"{pay_q / pay_fp:.4f} (gate 0.6); bf16 at this plan: {bf16}")
    os.remove(qpath)
    if quantized != "int16" or max(diff.values()) > charge \
            or pay_q > 0.6 * pay_fp or not bf16.startswith("refused"):
        raise RuntimeError("the quantized artifact failed its checks")
    del iq, qbase

    # ---- Section 5: space reduction and enhancement ---------------------
    red, t_red = timed(lambda: build.build_index(
        g, eps=EPS, c=0.6, seed=0, block=BLOCK, space_reduce=True,
        enhance=True, device=dev))
    entries = int(idx.hp.counts.sum())
    saved = 8 * (entries - int(red.hp.counts.sum()))
    spath = os.path.join(tmp, "enron-reduced.sling")
    _, t_ssave = timed(lambda: red.save(spath))
    round_trip = {}
    for mmap in (False, True):
        back = SlingIndex.load(spath, mmap=mmap,
                               device=None if mmap else dev)
        round_trip["mmap" if mmap else "eager"] = bool(
            np.array_equal(back.reduced, red.reduced)
            and np.array_equal(back.marks, red.marks)
            and same_tensors(back, red))
        del back
    try:
        QueryEngine(red, g, device=dev)
        refused = "served"
    except ValueError:
        refused = "refused"
    rng = np.random.default_rng(4)
    hu, hv = rng.integers(0, g.n, (2, 64))
    t = time.perf_counter()
    host_red = np.array([red.query_pair_host(int(u), int(v), g)
                         for u, v in zip(hu, hv)])
    t_host = (time.perf_counter() - t) / len(hu)
    host_full = np.array([idx.query_pair_host(int(u), int(v))
                          for u, v in zip(hu, hv)])
    gap = float(np.abs(host_red - host_full).max())
    print(f"[section5] build_index(space_reduce, enhance) {t_red:.2f}s "
          f"(d {red.build_seconds['d']:.2f}s, hp "
          f"{red.build_seconds['hp']:.2f}s, Section 5 on the host "
          f"{t_red - sum(red.build_seconds.values()):.2f}s): "
          f"{int(red.reduced.sum()):,} of {g.n:,} rows reduced, "
          f"{saved:,} bytes saved ({entries:,} -> "
          f"{int(red.hp.counts.sum()):,} entries), rows marked "
          f"{int((red.marks >= 0).any(1).sum()):,} (budget "
          f"{red.marks.shape[1]}); v3 {os.path.getsize(spath):,} bytes, "
          f"save {t_ssave:.3f}s, round trip equal {round_trip}; "
          f"QueryEngine: {refused}")
    print(f"[section5] 64 host pairs, query_pair_host(u, v, g) "
          f"{t_host * 1e3:.2f} ms each; reduced+enhanced vs unreduced, "
          f"max |diff| {gap:.3g}:")
    cells = [f"s({u},{v})={a:.6f}/{b:.6f}"
             for u, v, a, b in zip(hu, hv, host_red, host_full)]
    for lo in range(0, len(cells), 8):
        print("[section5]   " + " ".join(cells[lo:lo + 8]))
    os.remove(spath)
    if not all(round_trip.values()) or refused != "refused" \
            or not gap <= 2 * EPS:
        raise RuntimeError("the Section-5 index failed its checks")
    if min(path_launches.values()) <= 0:
        raise RuntimeError(f"a kernel did not launch on the artifact "
                           f"path: {path_launches}")
    return path_launches


class RssPeak:
    """The peak resident set of this process from its making to
    ``stop()``, from ``/proc/self/statm`` read every 5 ms on a thread
    (VmHWM cannot be reset, or is absent, on some kernels): ``peak_mb``,
    and ``start_mb`` at the making; ``None`` where statm cannot be
    read. ``whole_mb`` is ``ru_maxrss``, the peak of the whole
    process."""

    def __init__(self):
        import os
        import threading
        self.peak_mb = None
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._sample()
        self.start_mb = self.peak_mb
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        try:
            with open("/proc/self/statm") as f:
                mb = int(f.read().split()[1]) * self._page / 2**20
        except (OSError, ValueError, IndexError):
            return
        self.peak_mb = max(self.peak_mb or 0.0, mb)

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            self._sample()

    def stop(self) -> None:
        import resource
        self._stop.set()
        self._thread.join(timeout=5)
        self._sample()
        self.whole_mb = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0


def same_but_builder(a: str, b: str) -> bool:
    """Two v3 files equal byte for byte outside the header's ``builder``
    field: the preambles and headers equal with ``builder`` dropped,
    and every byte after the header equal (read in 64 MiB pieces)."""
    import struct
    heads = []
    for path in (a, b):
        with open(path, "rb") as f:
            magic, version, hlen = struct.unpack("<8sII", f.read(16))
            head = json.loads(f.read(hlen))
        head.pop("builder")
        heads.append((magic, version, head, 16 + hlen))
    if heads[0] != heads[1]:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        fa.seek(heads[0][3])
        fb.seek(heads[1][3])
        while True:
            x, y = fa.read(1 << 26), fb.read(1 << 26)
            if x != y:
                return False
            if not x:
                return True


def profile_sparse_build(g, p, dev, blocks: int = 4) -> None:
    """Trace ``blocks`` tail blocks of 4,096 targets and ``blocks`` hub
    batches of 128 of the scale build's sparse propagation."""
    import numpy as np

    from repro_torch.core import hp_index
    from repro_torch.prsim import hub_set, reverse_pagerank
    og = hp_index.OutGraph.from_graph(g, p.sqrt_c, dev)
    hubs = hub_set(reverse_pagerank(g, device=dev)[0])
    tail = np.setdiff1d(np.arange(g.n), hubs)

    def run():
        for i in range(blocks):
            hp_index._sparse_targets_coo(og, hubs[128 * i:128 * (i + 1)],
                                         p.theta, p.l_max)
            hp_index._sparse_targets_coo(og, tail[4096 * i:4096 * (i + 1)],
                                         p.theta, p.l_max)
    run()                                               # warm
    trace(f"sparse build at n={g.n:,}: {blocks} hub batches of 128 and "
          f"{blocks} tail blocks of 4,096 targets", run)


def scale_phase(dev, tmp, profile: bool = False):
    """Phase 3e, the scale path at 10^6 nodes (see the module docstring):
    ``build_index_scale`` with ``builder="auto"`` and again with
    ``"sling"``, the mapped file loaded and served by two engines
    (single-source and top-k batches of 2 and of 8, pairs in a batch of
    64). The counters are zeroed before the first build and read after
    the last batch; the comparison with the plain-backend engine runs
    after. Returns the path's launches and (g, plan, the B = 8 engine)
    for phase 4."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import build
    from repro_torch.core.index import SlingIndex
    from repro_torch.device import synchronize
    from repro_torch.graph import generators
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import EngineConfig, QueryEngine

    def timed(fn):
        synchronize(dev)
        t = time.perf_counter()
        out = fn()
        synchronize(dev)
        return out, time.perf_counter() - t

    rss = RssPeak()
    torch.cuda.reset_peak_memory_stats()
    g, t_gen = timed(lambda: generators.powerlaw_fast(N_SCALE, k=6, seed=0))
    print(f"[scale] powerlaw_fast({N_SCALE:,}, k=6, seed=0) in "
          f"{t_gen:.2f}s: n={g.n:,} m={g.m:,} max in-degree="
          f"{int(g.in_deg.max()):,}")
    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    for kern in kernels.values():
        kern.launches = 0
    horner_push_rows.steps = 0
    files, stats = {}, {}
    for builder in ("auto", "sling"):
        files[builder] = os.path.join(tmp, f"scale-{builder}.sling")
        stats[builder], wall = timed(lambda: build.build_index_scale(
            g, files[builder], eps=SCALE_EPS, quant_frac=QUANT_FRAC,
            quantize="int16", builder=builder, device=dev))
        st = stats[builder]
        print(f"[scale] build_index_scale(eps={SCALE_EPS}, quant_frac="
              f"{QUANT_FRAC}, int16, builder={builder!r}) -> "
              f"{st['builder']}, d_mode={st['d_mode']}: d "
              f"{st['d_wall_s']:.3f}s, hp {st['hp_wall_s']:.3f}s, pack "
              f"{st['pack_wall_s']:.3f}s, total {wall:.3f}s; entries "
              f"{st['entries']:,}, width {st['width']}, "
              f"{st['bytes']:,} bytes; prsim {st.get('prsim')}; skew "
              f"{st.get('skew')}")
    auto = stats["auto"]
    if auto["builder"] != "prsim" or auto["d_mode"] != "estimate" \
            or stats["sling"]["builder"] != "sling":
        raise RuntimeError(f"the scale build chose {auto['builder']} / "
                           f"{auto['d_mode']}, not prsim / estimate")
    same = same_but_builder(files["auto"], files["sling"])
    print(f"[scale] prsim file == sling file outside the header's "
          f"builder field: {same}")
    if not same:
        raise RuntimeError("the prsim and sling scale files differ")
    os.remove(files["sling"])
    path = files["auto"]
    idx, t_load = timed(lambda: SlingIndex.load(path, mmap=True))
    p = idx.plan
    engines, t_inst = {}, {}
    for B in (2, 8):
        engines[B], t_inst[B] = timed(lambda: QueryEngine.from_index_file(
            path, g, EngineConfig(pair_batch=64, source_batch=B),
            mmap=True, device=dev))
    rng = np.random.default_rng(5)
    q = rng.choice(g.n, 160, replace=False).astype(np.int32)
    # the hub and the widest row among the sources, and 8 pairs (u, u)
    q[0] = int(np.argmax(g.in_deg))
    q[1] = int(np.argmax(idx.hp.counts.numpy()))
    lat, got = {}, {}
    for B, eng in engines.items():
        for kind, fn in (("source", eng.single_source),
                         ("topk", lambda us: eng.topk(us, 10))):
            for lo in range(0, 2 * B, B):
                us = q[lo:lo + B] if kind == "source" \
                    else q[16 + lo:16 + lo + B]
                out, t = timed(lambda: fn(us))
                lat.setdefault(f"{kind} B={B}", []).append(t)
                got.setdefault((kind, B), []).append((us, out))
    pair_u, pair_v = q[32:96], q[96:160].copy()
    pair_v[:8] = pair_u[:8]
    pairs, t_pair = timed(lambda: engines[2].pairs(pair_u, pair_v))
    lat["pair 64"] = [t_pair]
    launches = {k: kern.launches for k, kern in kernels.items()}
    launches["horner_push_steps"] = horner_push_rows.steps
    rss.stop()
    dev_peak = torch.cuda.max_memory_allocated() / 2**30
    st = engines[8].stats()
    print(f"[scale] SlingIndex.load(mmap) {t_load * 1e3:.3f} ms; "
          f"from_index_file(mmap) install B=2 {t_inst[2] * 1e3:.1f} ms, "
          f"B=8 {t_inst[8] * 1e3:.1f} ms (width bucket "
          f"{engines[8]._width_cap}); backends pair={st['pair_backend']} "
          f"push={st['push_backend']} quantized={st['quantized']}")
    print("[scale] served: " + "; ".join(
        f"{k} " + "/".join(f"{1e3 * t:.3f}" for t in v) + " ms"
        for k, v in lat.items()) + f"; launches {launches}")
    phase_peak = ("not measured (no /proc/self/statm)"
                  if rss.peak_mb is None else f"{rss.peak_mb:.1f} MiB "
                  f"(at its start {rss.start_mb:.1f} MiB)")
    print(f"[scale] peak host RSS of the phase {phase_peak} (statm "
          f"every 5 ms), of the whole process {rss.whole_mb:.1f} MiB "
          f"(ru_maxrss); peak device memory {dev_peak:.3f} GiB; card "
          f"{card_line()}")
    if launches["hp_join"] <= 0 or launches["horner_push"] <= 0:
        raise RuntimeError(f"a kernel did not launch on the scale path: "
                           f"{launches}")
    if st["pair_backend"] != "kernel" or st["push_backend"] != "kernel":
        raise RuntimeError(f"the scale path did not use the kernels: {st}")

    # checks, outside the count: the plain backends on the card
    plain = QueryEngine(idx, g, EngineConfig(
        pair_backend="join", push_backend="plain", pair_batch=64,
        source_batch=8, cache_size=0), device=dev)
    err = {"pair": float(np.abs(plain.pairs(pair_u, pair_v) - pairs).max())}
    for (kind, B), outs in got.items():
        for us, out in outs:
            full = plain.single_source(us)
            if kind == "source":
                e = np.abs(full - out).max()
                ok = out.shape == (len(us), g.n) and np.isfinite(out).all()
            else:
                vals, ids = out
                pv, _ = plain.topk(us, 10)
                e = max(np.abs(pv - vals).max(), np.abs(
                    full[np.arange(len(us))[:, None], ids] - vals).max())
                ok = bool((np.diff(vals, axis=1) <= 0).all())
            if not ok:
                raise RuntimeError(f"{kind} B={B} answers are malformed")
            err[f"{kind} B={B}"] = max(err.get(f"{kind} B={B}", 0.0),
                                       float(e))
    print(f"[scale] kernels vs plain backends on the card: {err} "
          f"(BACKEND_ATOL {TOL_KERNEL}); pairs in [{pairs.min():.4g}, "
          f"{pairs.max():.4g}]")
    if max(err.values()) > TOL_KERNEL or not (0 <= pairs.min()
                                              <= pairs.max() <= 1):
        raise RuntimeError(f"the scale path's answers disagree: {err}")
    del plain, engines[2]
    if profile:
        profile_sparse_build(g, p, dev)
    return launches, (g, p, engines[8])


def options_phase(g, idx, dev, tmp) -> dict:
    """Phase 3e's second part, the build options on phase 3's graph:
    ``build_hp_table`` with ``spill_dir`` and a ``width`` 64 above the
    table's, held against phase 3's in-memory table (equal, the extra
    columns PAD). The counters are zeroed before and read after the
    build. Returns its launches."""
    import os

    import torch

    from repro_torch.core import hp_index
    from repro_torch.kernels.spmv_ell import spmm

    p, hp = idx.plan, idx.hp
    spill = os.path.join(tmp, "spill")
    spmm.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    wide = hp_index.build_hp_table(g, p.theta, p.sqrt_c, p.l_max,
                                   block=BLOCK, width=hp.width + 64,
                                   spill_dir=spill, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    launches = {"spmm": spmm.launches}
    W = hp.width
    files = os.listdir(spill)
    spilled = sum(os.path.getsize(os.path.join(spill, f)) for f in files)
    ok = {"width": wide.width == W + 64,
          "keys": torch.equal(wide.keys[:, :W], hp.keys),
          "vals": torch.equal(wide.vals[:, :W], hp.vals),
          "counts": torch.equal(wide.counts, hp.counts),
          "pad": bool((wide.keys[:, W:] == hp_index.INT32_PAD_KEY).all()
                      and (wide.vals[:, W:] == 0).all())}
    print(f"[options] build_hp_table(width={W + 64}, spill_dir) on "
          f"{g.n:,} nodes: {t:.2f}s, {len(files)} spill files, "
          f"{spilled:,} bytes; launches {launches}; equal to the "
          f"in-memory table with the extra columns PAD: {ok}")
    if not all(ok.values()) or launches["spmm"] <= 0:
        raise RuntimeError(f"the spilled, widened build failed: {ok}, "
                           f"{launches}")
    return launches


def update_phase(g, dev) -> dict:
    """The dynamic-graph path on the card at the Enron regime: build
    with ``STALE_FRAC``, warm an engine, then for each churn level in
    ``CHURN`` run ``update_index`` (theta_r = plan.theta), ``swap_index``
    into the warm engine and serve a few batches of each kind. The
    kernels' counters are zeroed before the batches and read after
    them, batch by batch; the checks (a from-scratch rebuild of the
    mutated graph, the affected sets recomputed for the row check) run
    after each batch's count is read.
    Returns the launches of the path."""
    import numpy as np
    import torch

    from repro_torch.core import build, update
    from repro_torch.graph import csr
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import EngineConfig, QueryEngine

    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=EPS, c=0.6, seed=1, block=BLOCK,
                            stale_frac=STALE_FRAC, device=dev)
    t_build = time.perf_counter() - t0
    p = idx.plan
    print(f"[update] build_index stale_frac={STALE_FRAC}: theta="
          f"{p.theta:.6g} eps_stale={p.eps_stale:.6g} l_max={p.l_max} "
          f"total={t_build:.2f}s width={idx.hp.width}")
    eng = QueryEngine(idx, g, EngineConfig(), device=dev)
    eng.warmup()
    shapes = eng.stats()["unique_shapes"]
    rng = np.random.default_rng(1)
    path, g_cur = {k: 0 for k in kernels}, g
    path["horner_push_steps"] = 0
    for i, churn in enumerate(CHURN):
        for kern in kernels.values():
            kern.launches = 0
        horner_push_rows.steps = 0
        q = rng.permutation(g.n)[:128].astype(np.int32)
        eng.pairs(q[:64], q[64:])               # fill the cache
        eng.single_source(q[:8])
        eng.topk(q[8:16], 10)
        m_batch = int(churn * g_cur.m)
        delta = update.random_delta(g_cur, n_add=m_batch // 2,
                                    n_del=m_batch - m_batch // 2,
                                    seed=100 + i)
        before = spmm.launches
        t0 = time.perf_counter()
        rep = build.update_index(idx, g_cur, delta, seed=10 + i,
                                 theta_r=p.theta)
        t_upd = time.perf_counter() - t0
        upd_spmm = spmm.launches - before
        sw = eng.swap_index(idx, rep.graph, affected=rep.affected)
        lat = {"pair": [], "source": [], "topk": []}
        served = {}
        for lo in range(0, 128, 64):
            t = time.perf_counter()
            served.setdefault("pair", []).append(
                eng.pairs(q[lo:lo + 32], q[lo + 32:lo + 64]))
            lat["pair"].append(time.perf_counter() - t)
        for lo in range(16, 32, 8):
            t = time.perf_counter()
            eng.single_source(q[lo:lo + 8])
            lat["source"].append(time.perf_counter() - t)
            t = time.perf_counter()
            eng.topk(q[lo + 16:lo + 24], 10)
            lat["topk"].append(time.perf_counter() - t)
        torch.cuda.synchronize()
        st = eng.stats()
        for k, kern in kernels.items():
            path[k] += kern.launches
        path["horner_push_steps"] += horner_push_rows.steps
        secs = " ".join(f"{k}={v:.3f}s" for k, v in rep.secs.items())
        print(f"[update {i}] churn {churn:.1%}: |delta|={len(delta)} "
              f"|touched|={len(rep.touched)} |R|={rep.rows_repaired} "
              f"|K|={rep.targets_seeded} |D|={rep.d_updated} "
              f"width_grew={rep.width_grew} update={t_upd:.3f}s ({secs}) "
              f"spmm launches={upd_spmm}")
        print(f"[update {i}] stale={rep.stale:.6g} eps_stale="
              f"{rep.eps_stale:.6g} needs_rebuild={rep.needs_rebuild}; swap "
              f"{sw['swap_ms']:.2f} ms, cache dropped {sw['cache_dropped']},"
              f" swap_recompiles={st['swap_recompiles']} (this swap "
              f"{sw['recompiles']}), shapes grew="
              f"{st['unique_shapes'] != shapes}, epoch={sw['epoch']}")
        for kind, ls in lat.items():
            print(f"[update {i}] served {kind}: {len(ls)} batches, "
                  f"per batch {pct(ls)}")
        # checks, outside the path's launch count
        e_pair = float(np.abs(np.concatenate(served["pair"]) - np.concatenate(
            [idx.query_pairs(q[lo:lo + 32], q[lo + 32:lo + 64], dev)
             for lo in (0, 64)])).max())
        g_new, touched, tv = csr.apply_edges(g_cur, delta)
        rows, targets, _, _, _ = update.affected_sets(
            g_cur, g_new, touched, tv, p, p.theta, device=dev)
        t0 = time.perf_counter()
        fresh = build.build_index(g_new, eps=EPS, c=0.6, seed=1,
                                  block=BLOCK, stale_frac=STALE_FRAC,
                                  device=dev)
        t_fresh = time.perf_counter() - t0
        chk = table_rows_vs_fresh(idx.hp, fresh.hp, rows, targets, p.theta)
        print(f"[update {i}] rows R x targets K vs a from-scratch rebuild "
              f"({t_fresh:.2f}s, update {t_upd:.3f}s): {chk}; engine pairs "
              f"vs the index's join: {e_pair:.3g}")
        if len(rows) != rep.rows_repaired or \
                len(targets) != rep.targets_seeded:
            raise RuntimeError("recomputed affected sets differ from the "
                               "update's")
        if not chk["ok"] or e_pair > TOL_KERNEL:
            raise RuntimeError(f"repaired rows disagree with a rebuild: "
                               f"{chk}, pairs {e_pair}")
        if upd_spmm <= 0:
            raise RuntimeError("update_index did not launch spmm")
        if sw["recompiles"] == 0 and st["unique_shapes"] != shapes:
            raise RuntimeError("a swap that fits grew the shape set")
        shapes = st["unique_shapes"]
        del fresh
        g_cur = rep.graph
    if min(path.values()) <= 0:
        raise RuntimeError(f"a kernel did not launch on the update path: "
                           f"{path}")
    del eng, idx
    return path


def spmm_chain(lay, h, tau: float, steps: int, stop: bool) -> list:
    """The (frontier, live mask) pairs that a block's steps hand ``spmm``,
    made by the plain version: up to ``steps`` propagations of ``h``,
    ending early (``stop``, the build's stop test) once nothing exceeds
    tau."""
    import torch

    from repro_torch.kernels.spmv_ell import segment_live, spmm_plain
    out, live = [], segment_live(h, tau)
    for _ in range(steps):
        out.append((h, live))
        nxt = torch.empty_like(live)
        h = spmm_plain(h, lay, tau=tau, live_out=nxt)
        live = nxt
        if stop and not bool(live.any()):
            break
    return out


def spmm_bytes(lay, x, live) -> tuple[float, float, int]:
    """What one masked step needs: (bytes, operations, live segments) --
    128 bytes per live segment of x read once, out written whole, the
    CSR, the mask words read and written; an FMA per column of each
    edge's live source segments."""
    import torch
    n, F = x.shape
    bits = (live.unsqueeze(-1) >> torch.arange(32, device=x.device)) & 1
    per_row = bits.sum(dim=(1, 2))
    segs = int(per_row.sum())
    m = lay.in_idx.numel()
    nbytes = (128 * segs + 4 * n * F + 8 * m + 4 * (n + 1)
              + 2 * 4 * live.numel())
    ops = 2 * 32 * int(per_row[lay.in_idx.long()].sum())
    return nbytes, ops, segs


def spmm_row(g, p, dev, nodes, launches: int) -> dict:
    """``spmm`` on what the main path hands it, at F = BLOCK: every step
    of one build block (targets 0..BLOCK-1, pull, theta, up to the stop
    test) and all l_max steps of one push mass-scan block (BLOCK seeds
    with weights in (0, 1], the update's theta_r of the stale_frac plan).
    On every step, and on both step-3 frontiers, the kernel as the path
    calls it (tau and the live mask) must equal the kernel dense on the
    pruned x bit for bit, fill live_out with ``segment_live`` of its
    output, and stay within TOL_KERNEL of ``spmm_plain``. Times: the
    step-3 frontiers masked, dense and through ``torch.sparse.mm``, and
    each block's mean per launch beside ``torch.sparse.mm`` on the same
    pruned frontiers. The row's bound is the step-3 pull frontier's data
    bound (:func:`spmm_bytes`); the dense bound is printed beside it."""
    import numpy as np
    import torch

    from repro_torch.core import theory
    from repro_torch.kernels.spmv_ell import (SpmmLayout, segment_live,
                                              spmm, spmm_plain)

    pull_lay = SpmmLayout.pull(g, p.sqrt_c, dev)
    push_lay = SpmmLayout.push(g, p.sqrt_c, dev)
    theta = float(np.float32(p.theta))
    theta_r = float(np.float32(theory.plan(
        eps=EPS, c=0.6, n=g.n, stale_frac=STALE_FRAC).theta))
    h = torch.zeros((g.n, BLOCK), device=dev)
    h[torch.arange(BLOCK, device=dev), torch.arange(BLOCK, device=dev)] = 1.0
    build_steps = spmm_chain(pull_lay, h, theta, p.l_max, stop=True)
    h = torch.zeros((g.n, BLOCK), device=dev)
    weights = 1.0 - np.random.default_rng(2).random(BLOCK, np.float32)
    h[torch.as_tensor(nodes[:BLOCK], device=dev),
      torch.arange(BLOCK, device=dev)] = torch.as_tensor(weights, device=dev)
    mass_steps = spmm_chain(push_lay, h, theta_r, p.l_max, stop=False)
    del h
    blocks = (("build", pull_lay, theta, build_steps),
              ("mass scan", push_lay, theta_r, mass_steps))
    out = torch.empty((g.n, BLOCK), device=dev)
    live_out = torch.empty_like(build_steps[0][1])

    def masked(x, live, lay, tau):
        return spmm(x, lay, out, tau=tau, live=live, live_out=live_out)

    # checks, step by step
    err = 0.0
    for name, lay, tau, steps in blocks:
        for i, (x, live) in enumerate(steps):
            got = masked(x, live, lay, tau).clone()
            same_mask = torch.equal(live_out, segment_live(got, tau))
            dense = spmm(torch.where(x > tau, x, 0.0), lay)
            e = float((got - spmm_plain(x, lay, tau=tau)).abs().max())
            err = max(err, e)
            if not torch.equal(got, dense) or not same_mask or \
                    not e <= TOL_KERNEL:
                raise RuntimeError(
                    f"spmm {name} step {i}: masked equals dense "
                    f"{torch.equal(got, dense)}, live_out equals "
                    f"segment_live {same_mask}, vs plain {e}")
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = {id(lay): torch.sparse_csr_tensor(
            lay.in_ptr.long(), lay.in_idx.long(), lay.w, size=(g.n, g.n),
            check_invariants=False) for lay in (pull_lay, push_lay)}
    # the step-3 frontiers
    t3 = {}
    for name, lay, tau, steps in blocks:
        x, live = steps[3]
        xp = torch.where(x > tau, x, 0.0)
        nb, ops, segs = spmm_bytes(lay, x, live)
        t3[name] = {
            "masked": time_ms(lambda: masked(x, live, lay, tau), 200),
            "dense": time_ms(lambda: spmm(xp, lay, out), 200),
            "library": time_ms(lambda: torch.sparse.mm(csr[id(lay)], xp),
                               200),
            "plain": time_ms(lambda: spmm_plain(
                x, lay, tau=tau, live_out=live_out), 20),
            "bound": bound_ms(nb, ops), "segs": segs,
            "nnz": int((xp > 0).sum())}
    # the path's mean per launch, one block of each kind
    means = {}
    for name, lay, tau, steps in blocks:
        pruned = [torch.where(x > tau, x, 0.0) for x, _ in steps]
        k_ms = time_ms(lambda: [masked(x, live, lay, tau)
                                for x, live in steps], 20) / len(steps)
        l_ms = time_ms(lambda: [torch.sparse.mm(csr[id(lay)], xp)
                                for xp in pruned], 20) / len(steps)
        need = [spmm_bytes(lay, x, live) for x, live in steps]
        b_mean = sum(bound_ms(nb, ops)[0] for nb, ops, _ in need) / len(need)
        segs = [sg for _, _, sg in need]
        means[name] = (k_ms, l_ms)
        print(f"[kernel] spmm {name} block ({len(steps)} launches, theta "
              f"{tau:.6g}): mean per launch masked {k_ms:.4f} ms, "
              f"torch.sparse.mm {l_ms:.4f} ms; mean data bound "
              f"{b_mean:.5f} ms; live segments per step {segs} of "
              f"{g.n * BLOCK // 32}")
        del pruned
    s_bytes = 4 * 2 * g.n * BLOCK + 8 * g.m + 4 * (g.n + 1) + 4 * g.n
    dense_ms, _ = bound_ms(s_bytes, 2 * g.m * BLOCK)
    for name, t in t3.items():
        print(f"[kernel] spmm {name} step-3 frontier: masked {t['masked']:.4f}"
              f" ms, dense {t['dense']:.4f} ms, torch.sparse.mm "
              f"{t['library']:.4f} ms, plain {t['plain']:.4f} ms; data "
              f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]}; "
              f"{t['segs']} live segments, {t['nnz']} nonzeros after the "
              f"prune), dense bound {dense_ms:.5f} ms")
    pull, build = t3["build"], means["build"]
    print(f"[kernel] spmm: the row's bound_ms is the step-3 pull frontier's "
          f"data bound; faster than torch.sparse.mm on the step-3 pull "
          f"frontier: {pull['masked'] < pull['library']}, as a mean over "
          f"the build block: {build[0] < build[1]}")
    return {"name": "spmm", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm.cu",
            "replaces": "src/repro/kernels/spmv_ell/spmv_ell.py:47",
            "launches": launches, "max_abs_err": err,
            "ms": pull["masked"], "plain_ms": pull["plain"],
            "bound_ms": pull["bound"][0], "bound_by": pull["bound"][1],
            "library_ms": pull["library"],
            "shape": f"n={g.n} m={g.m} F={BLOCK}, step-3 pull frontier"}


def device_ms(fn, key: str, reps: int) -> float:
    """Mean device milliseconds per call of the kernels whose name holds
    ``key`` in ``reps`` calls of ``fn``, from torch.profiler's device
    activity: the kernel alone, where back-to-back CUDA events would
    time the host's dispatch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for window in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(r.self_device_time_total for r in prof.key_averages()
                 if r.device_type == DeviceType.CUDA and key in r.key)
        if us > 0:
            return us / reps / 1e3
        # a window can come back without the kernel's activity records
        # though its launches ran (seen at n = 10^6): profile again
        print(f"[profile] no device time for {key} in profiler window "
              f"{window} of 3")
    raise RuntimeError(f"the profiler saw no device time for {key}")


def launch_floor(dev) -> tuple[float, float]:
    """A yardstick that the port does not call: a one-element in-place
    ``add_`` back to back, by CUDA events over 1,000 calls (what the
    host's dispatch allows) and by the profiler (the kernel alone)."""
    import torch
    x = torch.zeros(1, device=dev)
    return (time_ms(lambda: x.add_(1.0), 1000),
            device_ms(lambda: x.add_(1.0), "elementwise", 200))


def hp_join_row(eng, idx, pair_u, pair_v, launches: int) -> dict:
    """``hp_join`` at the engine's pair shapes (B = 256 pairs, K = the
    width bucket) against its plain version, with two calls held to
    equal bits. ``ms`` is the kernel's device time (profiler); the
    wrapper's back-to-back time and the launch floor are beside it. The
    bound counts the live entries of both rows of each pair, read once,
    and the ids and scores."""
    import torch

    from repro_torch.kernels.hp_join import hp_join, hp_join_plain
    dev = eng.device
    K = eng._width_cap
    us = torch.as_tensor(pair_u, device=dev)
    vs = torch.as_tensor(pair_v, device=dev)
    fk, fv = eng._keys, eng._folded_vals
    got = hp_join(fk, fv, us, vs)
    e_join = float((got - hp_join_plain(fk, fv, us, vs)).abs().max())
    if not torch.equal(got, hp_join(fk, fv, us, vs)):
        raise RuntimeError("two hp_join calls on the same inputs differ")
    cnt = idx.hp.counts.long()
    live = int(cnt[us.long()].sum() + cnt[vs.long()].sum())
    j_bytes = 8 * live + 4 * 3 * len(us)
    j_ops = 2 * int(cnt[us.long()].sum()) * (math.log2(K) + 1)
    b_ms, b_by = bound_ms(j_bytes, j_ops)
    floor_ms, floor_dev_ms = launch_floor(dev)
    row = {"name": "hp_join", "route": "cuda",
           "source": "src/repro_torch/csrc/hp_join.cu",
           "replaces": "src/repro/kernels/hp_join/hp_join.py:42",
           "launches": launches, "max_abs_err": e_join,
           "ms": device_ms(lambda: hp_join(fk, fv, us, vs),
                           "hp_join_kernel", 200),
           "plain_ms": time_ms(lambda: hp_join_plain(fk, fv, us, vs), 20),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "call_ms": time_ms(lambda: hp_join(fk, fv, us, vs), 200),
           "launch_floor_ms": floor_ms,
           "launch_floor_device_ms": floor_dev_ms,
           "shape": f"B={len(us)} K={K}"}
    print(f"[kernel] hp_join B={len(us)} K={K}: one block a pair; kernel "
          f"{row['ms']:.4f} ms (device time); call {row['call_ms']:.4f} ms "
          f"(CUDA events, back to back); launch_floor_ms "
          f"{floor_ms:.4f} (device {floor_dev_ms:.4f}); plain "
          f"{row['plain_ms']:.4f} ms; bound {b_ms:.5f} ms ({b_by}); "
          f"max_abs_err {e_join:.3g}; two calls equal bits")
    return row


def push_inputs(eng):
    """The engine's push inputs: the padded table, d, Â's layout, tau."""
    return eng._keys, eng._vals, eng._d, eng._layout, eng._tau


def horner_push_case(g, p, eng, sources) -> dict:
    """``horner_push`` on the engine's packed table for the rows
    ``sources`` (one batch) against the plain push on the card: error,
    equal bits from two pushes, the levels the kernel runs (from the
    plain level runs, outside the timed calls), and times: the whole
    push from the row ids on the card to the (B, n) result (CUDA events,
    back to back), the kernel alone (device time), the allocations that
    precede its launch, the plain push and ``torch.sparse.mm`` for all
    l_max + 1 levels. The bound counts each input byte once and the
    result once; ``streamed_bound_ms`` counts what the levels that ran
    stream: the CSR and a frontier read and written a level."""
    import torch

    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 horner_push_rows_plain,
                                                 level_runs_plain,
                                                 workspace_numel)
    keys, vals, d, lay, tau = push_inputs(eng)
    dev = keys.device
    n, L = g.n, p.l_max
    us = torch.as_tensor(sources, dtype=torch.long, device=dev)
    B = len(us)

    def push():
        return horner_push_rows(keys, vals, d, us, lay, tau, l_max=L)

    def plain():
        return horner_push_rows_plain(keys, vals, d, us, lay, tau, l_max=L)

    got = push()
    err = float((got - plain()).abs().max())
    if not torch.equal(got, push()):
        raise RuntimeError(f"two pushes of B={B} on the same inputs differ")
    levels_run = max(int(level_runs_plain(keys[us], n, L)[1].max()), 0) + 1

    def allocations():
        return (torch.empty((B, n), dtype=torch.float32, device=dev),
                torch.empty(workspace_numel(n, B, L), dtype=torch.float32,
                            device=dev))

    reps = 1000
    allocations()
    t0 = time.perf_counter()
    for _ in range(reps):
        allocations()
    alloc_ms = (time.perf_counter() - t0) / reps * 1e3
    live = int(eng.index.hp.counts.to(dev).long()[us].sum())
    csr_bytes = 8 * g.m + 4 * (n + 1)
    # inputs once: the ids, the live entries of the B rows (key, value
    # and d_k), the CSR; the (B, n) result once
    in_out = 8 * B + 12 * live + csr_bytes + 4 * n * B
    ops = 2 * levels_run * g.m * B
    b_ms, b_by = bound_ms(in_out, ops)
    streamed, _ = bound_ms(levels_run * (csr_bytes + 2 * 4 * n * B)
                           + 12 * live, ops)
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_csr = torch.sparse_csr_tensor(lay.in_ptr.long(),
                                        lay.in_idx.long(), lay.w,
                                        size=(n, n), check_invariants=False)
    x = torch.rand((n, B), device=dev)

    def library():
        y = x
        for _ in range(L + 1):
            y = torch.sparse.mm(a_csr, y)
        return y

    return {"B": B, "max_abs_err": err, "levels_run": levels_run,
            "ms": device_ms(push, "horner_push_kernel", 50),
            "push_ms": time_ms(push, 50), "alloc_ms": alloc_ms,
            "plain_ms": time_ms(plain, 10), "bound_ms": b_ms,
            "bound_by": b_by, "streamed_bound_ms": streamed,
            "library_ms": time_ms(library, 20),
            "parts": horner_push_parts(g, p, eng, us)}


def horner_push_parts(g, p, eng, us) -> dict:
    """Where the kernel's time goes, timed in this call (device time per
    push) on the same B rows: over the graph with no edge (the launch,
    the prologue, the barriers, the seeds and the units' bookkeeping),
    and over the rows cut to their level-0 keys (one level: the launch,
    the prologue and a level of seeds alone)."""
    import numpy as np
    import torch

    from repro_torch.core.hp_index import INT32_PAD_KEY
    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 level_runs_plain)
    from repro_torch.kernels.spmv_ell import SpmmLayout
    keys, vals, d, lay, tau = push_inputs(eng)
    dev = keys.device
    n, L = g.n, p.l_max
    none = np.zeros(0, np.int64)
    bare = SpmmLayout.from_edges(none, none, none, n, dev)
    rows_k, rows_v = keys[us].contiguous(), vals[us].contiguous()
    k0 = torch.where(rows_k < n, rows_k, INT32_PAD_KEY)   # still sorted
    ids = torch.arange(len(us), device=dev)
    out = {}
    for name, lay_x in (("all edges", lay), ("no edges", bare)):
        out[name] = device_ms(lambda: horner_push_rows(
            keys, vals, d, us, lay_x, tau, l_max=L), "horner_push_kernel", 50)
    out["level 0 only"] = device_ms(lambda: horner_push_rows(
        k0, rows_v, d, ids, lay, tau, l_max=L), "horner_push_kernel", 50)
    runs = max(int(level_runs_plain(rows_k, n, L)[1].max()), 1)
    per = {"bookkeeping, seeds and barrier":
           (out["no edges"] - out["level 0 only"]) / runs,
           "in-edges": (out["all edges"] - out["no edges"]) / runs}
    print(f"[kernel] horner_push n={g.n:,} B={len(us)} parts (device ms a "
          f"push): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
          + "; per level after the first: "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in per.items()))
    return {**out, **{f"per level: {k} (us)": v * 1e3
                      for k, v in per.items()}}


def horner_row(g, p, eng, nodes, launches: int, steps: int,
               scale) -> dict:
    """``horner_push`` at B = 8 (serving, the row) and B = 16 (the
    prior's batch, under ``b16``), each on a batch of the main path's
    nodes, and at B = 2 and 8 on phase 3e's 10^6-node engine (under
    ``n1e6``; ``scale`` is its (g, plan, engine)); see
    :func:`horner_push_case`."""
    import numpy as np

    from repro_torch.kernels.horner_push import persistent_grid
    cases = [horner_push_case(g, p, eng, nodes[512:512 + B])
             for B in (8, 16)]
    # at 10^6: the hub and the widest rows, whose seeds reach the
    # deepest levels (most rows hold level 0 alone at this eps)
    sg, sp, seng = scale
    wide = np.argsort(-seng.index.hp.counts.numpy(), kind="stable")
    big = [horner_push_case(sg, sp, seng, np.r_[np.argmax(sg.in_deg),
                                                wide[:B - 1]])
           for B in (2, 8)]
    for c, (gg, pp, ee) in [(c, (g, p, eng)) for c in cases] + \
            [(c, scale) for c in big]:
        print(f"[kernel] horner_push n={gg.n:,} B={c['B']}: "
              f"{c['levels_run']} of "
              f"{pp.l_max + 1} levels run in one launch (grid "
              f"{persistent_grid(ee._layout, c['B'])} blocks of 1,024); "
              f"whole push {c['push_ms']:.4f} ms (row ids on the card to "
              f"the (B, n) result, CUDA events); kernel {c['ms']:.4f} ms "
              f"(device time); before the launch only allocations, "
              f"{c['alloc_ms']:.4f} ms of host time; plain "
              f"{c['plain_ms']:.4f} ms; torch.sparse.mm x {pp.l_max + 1} "
              f"{c['library_ms']:.4f} ms; bound {c['bound_ms']:.5f} ms "
              f"({c['bound_by']}: inputs once, result once); streamed over "
              f"the levels run {c['streamed_bound_ms']:.5f} ms; max_abs_err "
              f"{c['max_abs_err']:.3g}; two pushes equal bits")
    row, b16 = cases
    return {"name": "horner_push", "route": "cuda",
            "source": "src/repro_torch/csrc/horner_push.cu",
            "replaces": "src/repro/kernels/horner_push/horner_push.py:69",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases + big),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "steps": steps,
            "levels_run": row["levels_run"], "push_ms": row["push_ms"],
            "alloc_ms": row["alloc_ms"],
            "streamed_bound_ms": row["streamed_bound_ms"],
            "parts": row["parts"],
            "b16": {k: v for k, v in b16.items() if k not in ("B", "parts")},
            "n1e6": {f"B={c['B']}": {k: v for k, v in c.items()
                                     if k not in ("B", "parts")}
                     for c in big},
            "shape": f"B=8 W={eng._width_cap} n={g.n} m={g.m} "
                     f"levels={p.l_max + 1}"}


def profile_single_source(eng, q) -> None:
    """Where a warm single-source batch of 8 spends its time: the engine
    path's parts run alone on fresh nodes, each timed on the host clock
    and ending in a synchronize -- the ids to the card (``_ids``), the
    push, the (8, n) copy to the host, the per-row cache copies and the
    LRU inserts -- beside ``QueryEngine.single_source`` on fresh nodes;
    then a torch.profiler trace of one more batch."""
    import torch

    from repro_torch.core.single_source import batched_single_source
    from repro_torch.serve.engine import _LRU
    torch.cuda.synchronize()
    walls = []
    for lo in range(0, 32, 8):
        t0 = time.perf_counter()
        eng.single_source(q[lo:lo + 8])
        walls.append(time.perf_counter() - t0)
    parts = {k: [] for k in ("ids", "push", "copy_to_host", "row_copies",
                             "lru")}
    for lo in range(32, 48, 8):
        us = q[lo:lo + 8]
        t0 = time.perf_counter()
        ids = eng._ids(us).long()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = batched_single_source(eng._keys, eng._vals, eng._d,
                                    eng._layout, ids, eng._tau,
                                    n=eng.index.n,
                                    l_max=eng.index.plan.l_max,
                                    backend=eng._push_backend)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = out.cpu().numpy()
        t3 = time.perf_counter()
        rows = [host[j].copy() for j in range(len(us))]
        t4 = time.perf_counter()
        lru = _LRU(eng.cfg.cache_size)
        for u, r in zip(us, rows):
            lru.put(("src", int(u)), r)
        t5 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3),
                                     (t3, t4), (t4, t5))):
            parts[k].append((b - a) * 1e3)
    print("[profile] single_source: a warm batch of 8 through the engine "
          + " ".join(f"{w * 1e3:.3f}" for w in walls) + " ms; its parts "
          "alone (two batches): "
          + " ".join(f"{k}=" + "/".join(f"{v:.3f}" for v in vs) + "ms"
                     for k, vs in parts.items()))
    trace("one single_source batch of 8",
          lambda: eng.single_source(q[48:56]))


def profile_build(g, p, dev, blocks: int = 4) -> None:
    """Trace ``blocks`` blocks of the Enron build loop (Alg 2 with the
    masked ``spmm``, the prune, the extraction and the stop test)."""
    import numpy as np
    import torch

    from repro_torch.core import hp_index
    from repro_torch.kernels.spmv_ell import SpmmLayout
    lay = SpmmLayout.pull(g, p.sqrt_c, dev)
    theta = float(np.float32(p.theta))

    def run():
        for b0 in range(0, blocks * BLOCK, BLOCK):
            tid = torch.arange(b0, b0 + BLOCK, device=dev)
            h = torch.zeros((g.n, BLOCK), device=dev)
            h[tid, tid - b0] = 1.0
            hp_index._propagate_block_coo(h, lay, theta, p.l_max, tid)
    run()                                               # warm
    trace(f"{blocks} Enron build blocks of {BLOCK} targets", run)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="Enron",
                    help="Table-3 regime of generators.paper_scale")
    ap.add_argument("--profile", action="store_true",
                    help="after the main path and in phases 3c and 3e, "
                         "trace a few more serve batches, four Enron "
                         "build blocks, one retrieval and eight batches "
                         "of the sparse scale build with torch.profiler "
                         "and print the tables by device and by CPU time")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import build
    from repro_torch.graph import generators
    from repro_torch.kernels import _build
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import EngineConfig, QueryEngine

    # fp32 products stay fp32 (no TF32) everywhere in this script
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device -------------------------------------------------------
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build the kernels ------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f}s "
          + " ".join(f"{k}={v:.2f}s" for k, v in built.items()))
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 3. main path at real size --------------------------------------
    g = generators.paper_scale(args.graph, seed=0)
    print(f"[main] graph {args.graph}: n={g.n} m={g.m} "
          f"max in-degree={int(g.in_deg.max())}")
    hp_join.launches = horner_push_rows.launches = spmm.launches = 0
    horner_push_rows.steps = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=EPS, c=0.6, seed=0, block=BLOCK,
                            device=dev, verbose=True)
    t_build = time.perf_counter() - t0
    p = idx.plan
    entries = int(idx.hp.counts.sum())
    print(f"[main] build_index eps={p.eps} c={p.c}: l_max={p.l_max} "
          f"theta={p.theta:.6g} n_r1={p.n_r1} d={idx.build_seconds['d']:.2f}s"
          f" hp={idx.build_seconds['hp']:.2f}s total={t_build:.2f}s "
          f"entries={entries} width={idx.hp.width} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    eng = QueryEngine(idx, g, EngineConfig(), device=dev)
    warm = eng.warmup()
    print("[main] warmup " + " ".join(f"{k}={v:.3f}s"
                                      for k, v in warm.items()))
    shapes = eng.stats()["unique_shapes"]
    rng = np.random.default_rng(0)
    nodes = rng.permutation(g.n)
    pair_u = nodes[:256].astype(np.int32)
    pair_v = nodes[256:512].astype(np.int32)
    src_q = nodes[512:576].astype(np.int32)
    top_q = nodes[576:640].astype(np.int32)
    queries = (pair_u, pair_v, src_q, top_q)
    answers, lat = serve_sample(eng, *queries)
    launches = {"hp_join": hp_join.launches,
                "horner_push": horner_push_rows.launches,
                "spmm": spmm.launches,
                "horner_push_steps": horner_push_rows.steps}
    st = eng.stats()
    for path, ls in lat.items():
        per = 64 if path == "pair" else 8
        print(f"[main] {path}: {len(ls)} batches of {per}: per batch "
              f"{pct(ls)}")
    print(f"[main] launches {launches}; backends pair={st['pair_backend']} "
          f"push={st['push_backend']}; batches={st['batches']} "
          f"pad_slots={st['pad_slots']} cache_hits={st['cache_hits']}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel did not launch on the main path: "
                           f"{launches}")
    if st["unique_shapes"] != shapes:
        raise RuntimeError("dispatch shape set grew after warmup")
    if st["pair_backend"] != "kernel" or st["push_backend"] != "kernel":
        raise RuntimeError(f"main path did not use the kernels: {st}")

    if args.profile:
        profile_serving(eng, nodes[640:704].astype(np.int32))
        profile_single_source(eng, nodes[704:760].astype(np.int32))
        profile_build(g, p, dev)

    plain = QueryEngine(idx, g, EngineConfig(pair_backend="join",
                                             push_backend="plain"),
                        device=dev)
    err = {
        "pair": float(np.abs(plain.pairs(pair_u, pair_v)
                             - np.concatenate(answers["pair"])).max()),
        "source": float(np.abs(plain.single_source(src_q[:16])
                               - np.concatenate(answers["source"][:2])
                               ).max()),
    }
    pv, pi = plain.topk(top_q[:16], 10)
    kv = np.concatenate([a[0] for a in answers["topk"][:2]])
    ki = np.concatenate([a[1] for a in answers["topk"][:2]])
    err["topk"] = float(np.abs(pv - kv).max())
    full = plain.single_source(top_q[:16])
    err["topk_ids"] = float(np.abs(full[np.arange(16)[:, None], ki]
                                   - pv).max())
    print(f"[main] kernels vs plain backends on the card: {err}")
    if max(err.values()) > TOL_KERNEL:
        raise RuntimeError(f"engine answers disagree with plain: {err}")
    del plain

    # ---- 3b. the dynamic-graph path at real size --------------------------
    upd = update_phase(g, dev)
    total = {k: launches[k] + upd[k] for k in launches}
    print(f"[update] launches {upd}; main path + update {total}")

    # ---- 3c. xDeepFM serving at full width, with the SLING prior -------
    model, serve_batch, rec = xdeepfm_phase(dev, profile=args.profile)
    for k in ("horner_push", "spmm", "horner_push_steps"):
        total[k] += rec[k]
    total["cin"] = rec["cin"]
    print(f"[xdeepfm] launches {rec}; all paths {total}")

    # ---- 3d. the index artifact: save, load, mmap, quantize, Section 5 --
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        art = artifact_phase(g, idx, answers, queries, dev, tmp)
    for k in art:
        total[k] += art[k]
    print(f"[artifact] launches {art}; all paths {total}")

    # ---- 3e. the scale path at 10^6 nodes, then the build options -------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        sc, scale = scale_phase(dev, tmp, profile=args.profile)
        opt = options_phase(g, idx, dev, tmp)
    for k in sc:
        total[k] += sc[k]
    total["spmm"] += opt["spmm"]
    print(f"[scale] launches {sc}; build options {opt}; all paths {total}")

    # ---- 4. each kernel vs its plain version at the main path's shapes --
    kernels = [hp_join_row(eng, idx, pair_u, pair_v, total["hp_join"]),
               horner_row(g, p, eng, nodes, total["horner_push"],
                          total["horner_push_steps"], scale)]
    del scale
    kernels.append(spmm_row(g, p, dev, nodes, total["spmm"]))
    kernels.append(cin_row(model, serve_batch, dev, total["cin"]))
    del model
    for k in kernels:
        print(f"[kernel] {k['name']} {k['shape']}: max_abs_err="
              f"{k['max_abs_err']:.3g} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f} "
              f"({k['bound_by']}) library_ms={k['library_ms']}"
              + (f" fma_bound_ms={k['fma_bound_ms']:.5f}"
                 if "fma_bound_ms" in k else "")
              + "".join(f" {x}={k[x]}" for x in ROW_EXTRAS if x in k))
        if k["name"] != "cin" and not k["max_abs_err"] <= TOL_KERNEL:
            raise RuntimeError(f"{k['name']} disagrees with its plain "
                               f"version: {k['max_abs_err']}")
    del eng, idx

    # ---- 5. accuracy against exact SimRank -------------------------------
    accuracy_phase(dev)

    # ---- 6. output --------------------------------------------------------
    print(json.dumps({"kernels": [{k: v for k, v in kk.items()
                                   if k not in ("shape", "fma_bound_ms",
                                                "parts", "b16", "n1e6")}
                                  for kk in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
