"""End-to-end serving driver on the PyTorch port (the paper's system is
an index: serving batched similarity queries IS the production
workload).

Simulates a query stream of mixed single-pair and single-source
requests against a built index, with request batching, latency
accounting, and an accuracy audit of sampled responses.

    PYTHONPATH=src python examples/torch_sling_serve.py [--n N] [--device D]

The index is built and served on ``--device`` (``cuda`` by default: the
pair join and the Horner push kernel on an NVIDIA card).
"""
import argparse
import time

import numpy as np

from repro_torch.core import build
from repro_torch.core.single_source import single_source_device
from repro_torch.device import resolve_device, synchronize
from repro_torch.graph import generators


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--eps", type=float, default=0.15)
    ap.add_argument("--pair-batches", type=int, default=20)
    ap.add_argument("--pair-batch-size", type=int, default=256)
    ap.add_argument("--source-batches", type=int, default=4)
    ap.add_argument("--source-batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = generators.barabasi_albert(args.n, 4, seed=0, directed=False)
    print(f"[serve] graph n={g.n} m={g.m}")
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=args.eps, seed=0, device=dev)
    synchronize(dev)
    print(f"[serve] index built in {time.perf_counter() - t0:.1f}s, "
          f"{idx.nbytes() / 1e6:.1f} MB")

    rng = np.random.default_rng(1)
    # warm up: the first calls upload the index and build Â's layout
    idx.query_pairs(np.zeros(args.pair_batch_size, np.int64),
                    np.zeros(args.pair_batch_size, np.int64), device=dev)
    single_source_device(idx, g, np.zeros(args.source_batch_size, np.int32),
                         device=dev)

    lat_pair, lat_src = [], []
    for _ in range(args.pair_batches):
        us = rng.integers(0, g.n, args.pair_batch_size)
        vs = rng.integers(0, g.n, args.pair_batch_size)
        t0 = time.perf_counter()
        idx.query_pairs(us, vs, device=dev)
        lat_pair.append(time.perf_counter() - t0)
    for _ in range(args.source_batches):
        qs = rng.integers(0, g.n, args.source_batch_size).astype(np.int32)
        t0 = time.perf_counter()
        single_source_device(idx, g, qs, device=dev)
        lat_src.append(time.perf_counter() - t0)

    n_pair = args.pair_batches * args.pair_batch_size
    n_src = args.source_batches * args.source_batch_size
    print(f"[serve] {n_pair} pair queries: "
          f"p50 {1e6 * np.median(lat_pair) / args.pair_batch_size:.1f} "
          f"us/query, p99 batch {1e3 * np.quantile(lat_pair, .99):.2f} ms")
    print(f"[serve] {n_src} single-source queries: "
          f"p50 {1e3 * np.median(lat_src) / args.source_batch_size:.2f} "
          f"ms/query")

    # accuracy audit on a sample (small graphs only)
    if g.n <= 1000:
        from repro_torch.baselines import power
        S = power.all_pairs(g, c=0.6, iters=50)
        us = rng.integers(0, g.n, 100)
        vs = rng.integers(0, g.n, 100)
        audit = np.abs(idx.query_pairs(us, vs, device=dev) - S[us, vs]).max()
        print(f"[serve] audit max err {audit:.4f} <= eps={args.eps}")


if __name__ == "__main__":
    main()
