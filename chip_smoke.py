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
  4. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and on its rows: max abs error, times (CUDA
     events), the card's bound and a library call's time where one
     exists;
  5. accuracy: on a 64-node graph built with the exact diagonal, every
     pair, single-source and top-k answer is within eps + 1e-5 of exact
     SimRank (power method);
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
import time
import warnings
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): memory
# bandwidth and non-tensor-core float32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TOL_KERNEL = 1e-5      # kernel vs plain version, float32 reduction order
EPS = 0.025            # the paper's Section-7.1 eps (c = 0.6)
BLOCK = 2048           # target columns per Alg-2 frontier block


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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pct(lat_s: list[float]) -> str:
    import numpy as np
    a = 1e3 * np.asarray(lat_s)
    return (f"p50 {np.percentile(a, 50):.3f} ms p99 "
            f"{np.percentile(a, 99):.3f} ms")


def profile_serving(eng, q) -> None:
    """Trace 4 pair, 4 single-source and 4 top-k batches (fresh nodes,
    so no cache hits) and print the device's busy share of the window:
    the device time of kernels and copies over the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for lo in range(0, 32, 8):
            eng.pairs(q[lo:lo + 8], q[lo + 32:lo + 40])
            eng.single_source(q[lo:lo + 8])
            eng.topk(q[lo + 32:lo + 40], 10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # device-side rows only (kernels, copies, memsets), as the table's
    # own "Self CUDA time total"; an aten op's row repeats its kernels
    dev = sum(r.self_device_time_total for r in rows
              if r.device_type == DeviceType.CUDA
              and not getattr(r, "is_user_annotation", False)) / 1e6
    print(f"[profile] 12 batches: wall {wall * 1e3:.3f} ms, device busy "
          f"{dev * 1e3:.3f} ms ({100 * dev / wall:.1f}%)")
    for sort_by in ("self_device_time_total", "cpu_time_total"):
        for line in rows.table(sort_by=sort_by, row_limit=15).splitlines():
            print(f"[profile] {line}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="Enron",
                    help="Table-3 regime of generators.paper_scale")
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, trace a few more serve "
                         "batches with torch.profiler and print the "
                         "tables by device and by CPU time")
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

    from repro_torch.baselines import power
    from repro_torch.core import build
    from repro_torch.graph import generators
    from repro_torch.kernels import _build
    from repro_torch.kernels.horner_push import (horner_push, horner_steps,
                                                 horner_steps_plain)
    from repro_torch.kernels.hp_join import hp_join, hp_join_plain
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
    hp_join.launches = 0
    horner_steps.launches = 0
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
    lat = {"pair": [], "source": [], "topk": []}
    answers = {}
    pair_u = nodes[:256].astype(np.int32)
    pair_v = nodes[256:512].astype(np.int32)
    for lo in range(0, 256, 64):
        t = time.perf_counter()
        answers.setdefault("pair", []).append(
            eng.pairs(pair_u[lo:lo + 64], pair_v[lo:lo + 64]))
        lat["pair"].append(time.perf_counter() - t)
    src_q = nodes[512:576].astype(np.int32)
    top_q = nodes[576:640].astype(np.int32)
    for lo in range(0, 64, 8):
        t = time.perf_counter()
        answers.setdefault("source", []).append(
            eng.single_source(src_q[lo:lo + 8]))
        lat["source"].append(time.perf_counter() - t)
        t = time.perf_counter()
        answers.setdefault("topk", []).append(eng.topk(top_q[lo:lo + 8], 10))
        lat["topk"].append(time.perf_counter() - t)
    launches = {"hp_join": hp_join.launches,
                "horner_push": horner_steps.launches}
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

    # ---- 4. each kernel vs its plain version at the main path's shapes --
    kernels = []
    K = eng._width_cap
    us = torch.as_tensor(pair_u, device=dev)
    vs = torch.as_tensor(pair_v, device=dev)
    fk, fv = eng._folded_keys, eng._folded_vals
    got = hp_join(fk, fv, us, vs)
    ref = hp_join_plain(fk, fv, us, vs)
    e_join = float((got - ref).abs().max())
    cnt = idx.hp.counts.long()
    live = int(cnt[us.long()].sum() + cnt[vs.long()].sum())
    j_bytes = 8 * live + 4 * 3 * len(us)
    j_ops = 2 * int(cnt[us.long()].sum()) * (math.log2(K) + 1)
    b_ms, b_by = bound_ms(j_bytes, j_ops)
    kernels.append({
        "name": "hp_join", "route": "cuda",
        "source": "src/repro_torch/csrc/hp_join.cu",
        "replaces": "src/repro/kernels/hp_join/hp_join.py:42",
        "launches": launches["hp_join"], "max_abs_err": e_join,
        "ms": time_ms(lambda: hp_join(fk, fv, us, vs), 200),
        "plain_ms": time_ms(lambda: hp_join_plain(fk, fv, us, vs), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"B={len(us)} K={K}"})

    sq = torch.as_tensor(src_q[:8], dtype=torch.long, device=dev)
    ku, xu = eng._keys[sq], eng._vals[sq]
    lay, d, tau, L = eng._layout, eng._d, eng._tau, p.l_max

    def push(steps):
        return horner_push(ku, xu, d, lay, tau, n=g.n, l_max=L, steps=steps)

    e_push = float((push(horner_steps) - push(horner_steps_plain)).abs().max())
    B = ku.shape[0]
    live_rows = int(cnt[sq].sum())
    h_bytes = (12 * live_rows + 4 * (g.n + 1) + 8 * g.m + 4 * g.n * B)
    h_ops = 2 * (L + 1) * g.m * B
    b_ms, b_by = bound_ms(h_bytes, h_ops)
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_csr = torch.sparse_csr_tensor(lay.in_ptr.long(),
                                        lay.in_idx.long(), lay.w,
                                        size=(g.n, g.n),
                                        check_invariants=False)
    x = torch.rand((g.n, B), device=dev)

    def library():
        y = x
        for _ in range(L + 1):
            y = torch.sparse.mm(a_csr, y)
        return y

    kernels.append({
        "name": "horner_push", "route": "cuda",
        "source": "src/repro_torch/csrc/horner_push.cu",
        "replaces": "src/repro/kernels/horner_push/horner_push.py:69",
        "launches": launches["horner_push"], "max_abs_err": e_push,
        "ms": time_ms(lambda: push(horner_steps), 50),
        "plain_ms": time_ms(lambda: push(horner_steps_plain), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library, 20),
        "shape": f"B={B} W={K} n={g.n} m={g.m} steps={L + 1}"})
    for k in kernels:
        print(f"[kernel] {k['name']} {k['shape']}: max_abs_err="
              f"{k['max_abs_err']:.3g} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f} "
              f"({k['bound_by']}) library_ms={k['library_ms']}")
        if not k["max_abs_err"] <= TOL_KERNEL:
            raise RuntimeError(f"{k['name']} disagrees with its plain "
                               f"version: {k['max_abs_err']}")
    del eng, idx

    # ---- 5. accuracy against exact SimRank -------------------------------
    small = generators.barabasi_albert(64, 3, seed=1, directed=False)
    sidx = build.build_index(small, eps=EPS, c=0.6, exact_d=True,
                             device=dev)
    S = power.all_pairs(small, c=0.6, iters=power.iterations_for(1e-9, 0.6))
    tol = sidx.plan.eps + 1e-5
    seng = QueryEngine(sidx, small, EngineConfig(cache_size=0), device=dev)
    n = small.n
    uu, vv = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    acc = {"pair": float(np.abs(seng.pairs(uu.ravel(), vv.ravel())
                                .reshape(n, n) - S).max()),
           "source": float(np.abs(seng.single_source(np.arange(n))
                                  - S).max())}
    sv, si = seng.topk(np.arange(n), 10)
    acc["topk"] = float(np.abs(sv - S[np.arange(n)[:, None], si]).max())
    # a returned node's exact score is at most 2 tol below the exact
    # 10th best (both sides are within tol of exact)
    kth = np.sort(S, axis=1)[:, ::-1][:, 9]
    gap = float(max(0.0, (kth[:, None] - S[np.arange(n)[:, None], si]).max()))
    print(f"[accuracy] n={n} eps={sidx.plan.eps} max |err| {acc} "
          f"(bound {tol:.6g}); top-k rank gap {gap:.3g} (bound {2 * tol:.6g})")
    if max(acc.values()) > tol or gap > 2 * tol:
        raise RuntimeError(f"answers beyond eps of exact SimRank: {acc}")

    # ---- 6. output --------------------------------------------------------
    print(json.dumps({"kernels": [{k: v for k, v in kk.items()
                                   if k != "shape"} for kk in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
