"""Serving CLI: build an index over a synthetic graph, warm the engine,
serve a query stream through it and report latency.

    python -m repro_torch.launch.serve --n 2000 --queries 64 --mode mixed
    python -m repro_torch.launch.serve --device cpu --n 200 --queries 8

Port of the direct-engine path of ``repro/launch/serve.py``. Runs on
``cuda`` unless ``--device cpu``. The last line says whether the set of
dispatch shapes grew after warmup.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import build
from repro_torch.graph import generators
from repro_torch.serve import EngineConfig, QueryEngine


def _percentiles(lat: list[float]) -> str:
    a = 1e3 * np.asarray(lat)
    return (f"p50 {np.percentile(a, 50):.3f} ms  "
            f"p99 {np.percentile(a, 99):.3f} ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--deg", type=int, default=4)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mode", default="source",
                    choices=("source", "pair", "topk", "mixed"))
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.queries < 1 or args.batch < 1:
        ap.error("--queries and --batch must be >= 1")

    g = generators.barabasi_albert(args.n, args.deg, seed=args.seed,
                                   directed=False)
    print(f"graph: n={g.n} m={g.m}")
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=args.eps, seed=args.seed,
                            device=args.device, verbose=True)
    print(f"index built in {time.perf_counter() - t0:.2f}s "
          f"({idx.nbytes() / 1e6:.1f} MB)")

    eng = QueryEngine(idx, g, EngineConfig(
        source_batch=args.batch, pair_batch=max(args.batch, 16)),
        device=args.device)
    warm = eng.warmup()
    print("warmup: " + "  ".join(f"{k}={v:.3f}s" for k, v in warm.items()))

    rng = np.random.default_rng(args.seed)
    qs = rng.integers(0, g.n, args.queries).astype(np.int32)
    modes = {"source": ["source"], "pair": ["pair"], "topk": ["topk"],
             "mixed": ["source", "pair", "topk"]}[args.mode]
    shapes_before = len(eng.stats()["unique_shapes"])
    for mode in modes:
        lat = []
        for lo in range(0, args.queries, args.batch):
            batch = qs[lo:lo + args.batch]
            t0 = time.perf_counter()
            if mode == "source":
                sample = eng.single_source(batch)[0][:5]
            elif mode == "pair":
                vs = rng.integers(0, g.n, len(batch)).astype(np.int32)
                sample = eng.pairs(batch, vs)[:5]
            else:
                sample = eng.topk(batch, args.k)[0][0]
            lat.append((time.perf_counter() - t0) / len(batch))
        print(f"[{mode}] {args.queries} queries, batch={args.batch}: "
              f"{_percentiles(lat)} per query")
        print(f"[{mode}] sample: {np.round(np.asarray(sample), 4)}")

    st = eng.stats()
    grew = len(st["unique_shapes"]) - shapes_before
    print(f"engine: {st['batches']} batches, {st['pad_slots']} pad slots, "
          f"cache {st['cache_hits']}/"
          f"{st['cache_hits'] + st['cache_misses']} hits, "
          f"pair={st['pair_backend']} push={st['push_backend']} "
          f"device={st['device']}")
    print(f"dispatch shapes: {len(st['unique_shapes'])} total, {grew} new "
          f"after warmup "
          f"({'fixed shape set OK' if grew == 0 else 'SHAPES GREW'})")
    if grew:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
