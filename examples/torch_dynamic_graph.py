"""Dynamic-graph serving on the PyTorch port: build once, mutate
forever.

A SimRank service over a graph that keeps changing: this example builds
an index with a staleness reserve, serves top-k queries, then streams
edge-churn batches through the incremental maintenance path (DESIGN.md
section 7) -- repair, hot-swap, keep serving -- and prints the
accounting that decides when a full rebuild is due, including the
trigger firing and the rebuild itself.

    PYTHONPATH=src python examples/torch_dynamic_graph.py [--n N] [--device D]

Everything runs on ``--device`` (``cuda`` by default).
"""
import argparse
import time

import numpy as np

from repro_torch.core import build, update
from repro_torch.graph import generators
from repro_torch.serve import EngineConfig, QueryEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1500)
    ap.add_argument("--eps", type=float, default=0.15)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--churn", type=float, default=0.005)
    ap.add_argument("--stale-frac", type=float, default=0.2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    g = generators.barabasi_albert(args.n, 4, seed=0, directed=False)
    print(f"graph: n={g.n} m={g.m}")
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=args.eps, seed=0,
                            stale_frac=args.stale_frac, device=dev)
    print(f"built in {time.perf_counter() - t0:.1f}s; staleness "
          f"reserve eps_stale={idx.plan.eps_stale:.4f} "
          f"(static guarantee planned at "
          f"{args.eps * (1 - args.stale_frac):.4f})")

    eng = QueryEngine(idx, g, EngineConfig(source_batch=4), device=dev)
    eng.warmup()
    probe = np.array([1, 2, 3, 5], np.int32)
    sv, si = eng.topk(probe, 5)
    print(f"serving: top-5 of node {probe[0]}: "
          f"{list(zip(si[0].tolist(), np.round(sv[0], 4).tolist()))}")

    m_batch = max(2, int(g.m * args.churn))
    for i in range(args.batches):
        delta = update.random_delta(g, n_add=m_batch // 2,
                                    n_del=m_batch - m_batch // 2,
                                    seed=100 + i)
        t0 = time.perf_counter()
        rep = build.update_index(idx, g, delta, seed=i)
        g = rep.graph
        sw = eng.swap_index(idx, g, affected=rep.affected)
        print(f"[batch {i}] {m_batch} edge mutations -> "
              f"{len(rep.touched)} touched in-neighborhoods, "
              f"{rep.rows_repaired} rows + {rep.d_updated} d repaired "
              f"in {time.perf_counter() - t0:.2f}s; swap "
              f"{sw['swap_ms']:.1f}ms ({sw['recompiles']} recompiles, "
              f"{sw['cache_dropped']} cache entries dropped); "
              f"stale {rep.stale:.4f} / {rep.eps_stale:.4f}")
        sv, si = eng.topk(probe, 5)
        print(f"          top-5 of node {probe[0]} now: "
              f"{list(zip(si[0].tolist(), np.round(sv[0], 4).tolist()))}")
        if rep.needs_rebuild:
            print("          staleness reserve spent -> full rebuild")
            t0 = time.perf_counter()
            idx = build.build_index(g, eps=args.eps, seed=0,
                                    stale_frac=args.stale_frac, device=dev)
            eng.swap_index(idx, g)
            print(f"          rebuilt + swapped in "
                  f"{time.perf_counter() - t0:.1f}s (epoch reset)")

    st = eng.stats()
    print(f"engine: {st['swaps']} swaps, {st['swap_recompiles']} bucket "
          f"overflows, epoch {st['epoch']}, last swap "
          f"{st['last_swap_ms']:.1f}ms")


if __name__ == "__main__":
    main()
