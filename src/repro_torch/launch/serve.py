"""Serving CLI: build an index over a synthetic graph, warm the engine,
serve a query stream through it and report latency.

    python -m repro_torch.launch.serve --n 2000 --queries 64 --mode mixed
    python -m repro_torch.launch.serve --device cpu --n 200 --queries 8
    python -m repro_torch.launch.serve --n 2000 --mutate 3 --churn 0.01

Port of ``repro/launch/serve.py``. Runs on ``cuda`` unless ``--device
cpu``. The last serving line says whether the set of dispatch shapes
grew after warmup.
``--pair-backend join|kernel`` picks the pair path (``auto``: the
kernel on ``cuda``, the join on the CPU).

Artifacts: ``--quantize int16|bf16`` with ``--quant-frac F`` builds with
F of eps reserved for quantization and serves the quantized index;
``--save-index PATH`` writes the index (format v3) after building, and
``--index PATH`` serves a saved one instead of building (``--mmap``
maps it read-only, zero-copy); the graph is regenerated from
``--n``/``--deg``/``--seed`` and must match:

    python -m repro_torch.launch.serve --n 2000 --quantize int16 \
        --quant-frac 0.25 --save-index /tmp/i.sling
    python -m repro_torch.launch.serve --n 2000 --index /tmp/i.sling --mmap

``--mutate N`` appends an edge-churn replay: N random insert/delete
batches of ``--churn`` of the edges each go through ``update_index``
and are hot-swapped into the live engine between query batches
(``swap_index``), with the index built with ``--stale-frac`` of eps
reserved for staleness. Each batch prints its repair time, swap latency,
cache entries dropped and the staleness against the reserve; when the
reserve is spent the index is rebuilt and swapped in. The last line
says whether any swap grew a bucket or the shape set. ``--theta-r``
overrides the repair threshold (default: the plan's theta).

``--mesh S`` serves node-sharded: the index is cut into node slabs over
an S-way "data" mesh axis and single-source and top-k fan out over them
(``core/shard_query.py``); pairs stay on the mesh's first device. On the
card the mesh takes the first S CUDA devices (there must be S); with
``--device cpu`` it is S shards on the CPU:

    python -m repro_torch.launch.serve --device cpu --n 200 --queries 8 \
        --mode mixed --mesh 4 --mutate 2

``--frontend R`` serves through the async SLO-aware admission layer
(``ServeFrontend``) instead of calling the engine directly: R engine
replicas over the one index, deadline-aware batch formation
(``--max-wait-ms``), per-request deadlines with shed-on-expiry
(``--deadline-ms``), least-loaded or round-robin routing
(``--routing``) and a Zipf(``--zipf``) query stream. Each mode reports
p50/p99 admission-to-result latency, sheds and throughput; ``--mutate``
swaps go through the frontend's epoch barrier:

    python -m repro_torch.launch.serve --device cpu --n 200 --frontend 2 \
        --mode mixed --queries 16 --deadline-ms 5000 --mutate 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import build, quantize, shard_query, update
from repro_torch.core.index import SlingIndex
from repro_torch.graph import generators
from repro_torch.serve import (EngineConfig, FrontendConfig, QueryEngine,
                               ServeFrontend, zipf_nodes)

MODES = {"source": ["source"], "pair": ["pair"], "topk": ["topk"],
         "mixed": ["source", "pair", "topk"]}


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
    ap.add_argument("--pair-backend", default="auto",
                    choices=("auto", "join", "kernel"))
    ap.add_argument("--mesh", type=int, default=0, metavar="S",
                    help="node-shard the index over an S-way mesh and "
                         "fan single-source/top-k out over it (0 = one "
                         "device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mutate", type=int, default=0, metavar="N",
                    help="replay N edge-churn batches with incremental "
                         "update_index + hot-swap after the query loop")
    ap.add_argument("--churn", type=float, default=0.01,
                    help="fraction of edges mutated per --mutate batch")
    ap.add_argument("--theta-r", type=float, default=None,
                    help="repair threshold override (default: plan "
                         "theta, the sound operating point)")
    ap.add_argument("--stale-frac", type=float, default=0.2,
                    help="fraction of eps reserved for update staleness")
    ap.add_argument("--frontend", type=int, default=0, metavar="R",
                    help="serve through the async SLO-aware frontend "
                         "with R engine replicas (0 = direct engine)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="frontend batch-close wait bound")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline; expired requests are "
                         "shed, not served (0 = no deadline)")
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="frontend query-skew exponent (0 = uniform)")
    ap.add_argument("--routing", default="least_loaded",
                    choices=("least_loaded", "round_robin"))
    ap.add_argument("--index", default=None, metavar="PATH",
                    help="serve a persisted index artifact instead of "
                         "building one (graph is regenerated from "
                         "--n/--deg/--seed and must match)")
    ap.add_argument("--mmap", action="store_true",
                    help="with --index: map the artifact read-only "
                         "(format v3; O(1) load, replicas share pages)")
    ap.add_argument("--save-index", default=None, metavar="PATH",
                    help="persist the index (format v3) after building")
    ap.add_argument("--quantize", default="none",
                    choices=("none", "int16", "bf16"),
                    help="serve a quantized index (needs --quant-frac "
                         "> 0)")
    ap.add_argument("--quant-frac", type=float, default=0.0,
                    help="fraction of eps reserved for quantization "
                         "error (plan eps_quant_frac)")
    args = ap.parse_args(argv)
    if args.queries < 1 or args.batch < 1:
        ap.error("--queries and --batch must be >= 1")
    if args.quantize != "none" and args.quant_frac <= 0:
        ap.error("--quantize needs --quant-frac > 0 (the plan must "
                 "reserve the quantization budget)")
    if args.mutate and (args.quantize != "none" or args.mmap):
        ap.error("--mutate needs a writable fp32 index; quantized/"
                 "mmap'd artifacts are read-only")

    mesh = None
    if args.mesh > 0:
        mesh = shard_query.serving_mesh(
            args.mesh, devices=(["cpu"] * args.mesh
                                if args.device == "cpu" else None))
        print(f"mesh: {args.mesh}-way node-sharded serving over 'data' "
              f"on {', '.join(str(d) for d in mesh.axis_devices('data'))}")

    g = generators.barabasi_albert(args.n, args.deg, seed=args.seed,
                                   directed=False)
    print(f"graph: n={g.n} m={g.m}")
    t0 = time.perf_counter()
    if args.index:
        idx = SlingIndex.load(args.index, mmap=args.mmap,
                              device=None if args.mmap else args.device)
        if idx.n != g.n:
            raise SystemExit(f"--index has n={idx.n}, graph has "
                             f"n={g.n}; pass matching --n/--deg/--seed")
        print(f"index loaded in {time.perf_counter() - t0:.3f}s "
              f"({idx.nbytes() / 1e6:.1f} MB"
              f"{', mmap' if args.mmap else ''}"
              f"{', ' + idx.quant.scheme if idx.quant else ''})")
    else:
        idx = build.build_index(g, eps=args.eps, seed=args.seed,
                                stale_frac=args.stale_frac if args.mutate
                                else 0.0, quant_frac=args.quant_frac,
                                device=args.device, verbose=True)
        if args.quantize != "none":
            idx = quantize.quantize_index(idx, scheme=args.quantize)
            print(f"index quantized ({args.quantize}): "
                  f"{idx.nbytes() / 1e6:.1f} MB")
        print(f"index built in {time.perf_counter() - t0:.2f}s "
              f"({idx.nbytes() / 1e6:.1f} MB)")
    if args.save_index:
        idx.save(args.save_index)
        print(f"index saved -> {args.save_index}")

    if args.frontend > 0:
        _frontend_serve(args, g, idx, mesh)
        return
    eng = QueryEngine(idx, g, _engine_config(args, mesh),
                      device=args.device)
    warm = eng.warmup()
    print("warmup: " + "  ".join(f"{k}={v:.3f}s" for k, v in warm.items()))

    rng = np.random.default_rng(args.seed)
    qs = rng.integers(0, g.n, args.queries).astype(np.int32)
    shapes_before = len(eng.stats()["unique_shapes"])
    for mode in MODES[args.mode]:
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
          f"device={st['device']} mesh={st['mesh_shards']}")
    print(f"dispatch shapes: {len(st['unique_shapes'])} total, {grew} new "
          f"after warmup "
          f"({'fixed shape set OK' if grew == 0 else 'SHAPES GREW'})")
    if grew:
        raise SystemExit(1)
    if args.mutate:
        _mutate_replay(args, g, idx, eng, qs)


def _engine_config(args, mesh) -> EngineConfig:
    return EngineConfig(source_batch=args.batch,
                        pair_batch=max(args.batch, 16),
                        pair_backend=args.pair_backend, mesh=mesh)


def _frontend_serve(args, g, idx, mesh) -> None:
    """Zipf traffic through the SLO-aware frontend, mode by mode, then
    the churn replay through its swap barrier; every replica shards the
    index over ``mesh`` when one is given."""
    fe = ServeFrontend(idx, g, FrontendConfig(
        max_batch=args.batch, max_pair_batch=max(args.batch, 16),
        max_wait=args.max_wait_ms / 1e3,
        default_timeout=(args.deadline_ms / 1e3
                         if args.deadline_ms > 0 else None),
        replicas=args.frontend, routing=args.routing,
        engine=_engine_config(args, mesh)),
        device=args.device)
    with fe:
        warm = fe.warmup()
        deadline = (f"{args.deadline_ms:g}ms" if args.deadline_ms > 0
                    else "none")
        print(f"frontend: {args.frontend} replicas, {args.routing} "
              f"routing, max_wait {args.max_wait_ms}ms, deadline "
              f"{deadline}, zipf s={args.zipf}")
        print("warmup (max over replicas): "
              + "  ".join(f"{k}={v:.3f}s" for k, v in warm.items()))
        us = zipf_nodes(g.n, args.queries, s=args.zipf, seed=args.seed)
        vs = zipf_nodes(g.n, args.queries, s=args.zipf, seed=args.seed + 1)
        shapes_before = len(fe.stats()["unique_shapes"])
        for mode in MODES[args.mode]:
            t0 = time.perf_counter()
            if mode == "source":
                tickets = [fe.submit_source(int(u)) for u in us]
            elif mode == "pair":
                tickets = [fe.submit_pair(int(u), int(v))
                           for u, v in zip(us, vs)]
            else:
                tickets = [fe.submit_topk(int(u), args.k) for u in us]
            fe.flush()
            fe.drain(timeout=120.0)
            wall = time.perf_counter() - t0
            lat = [t.latency for t in tickets if not t.shed]
            shed = sum(t.shed for t in tickets)
            pct = _percentiles(lat) if lat else "all shed"
            print(f"[frontend {mode}] {args.queries} requests: {pct}  "
                  f"shed {shed}/{args.queries}  "
                  f"{args.queries / wall:.0f} req/s")
        if args.mutate:
            _frontend_mutate(args, g, idx, fe, us)
        st = fe.stats()
    grew = len(st["unique_shapes"]) - shapes_before
    print(f"frontend: {st['batches']} batches, occupancy "
          f"{st['mean_occupancy']:.2f}, cache {st['cache_hits']}/"
          f"{st['cache_hits'] + st['cache_misses']} hits over "
          f"{st['replicas']} replicas, device "
          f"{st['per_replica'][0]['device']}")
    print(f"dispatch shapes: {len(st['unique_shapes'])} total, {grew} new "
          f"after warmup "
          f"({'fixed shape set OK' if grew == 0 else 'SHAPES GREW'})")
    if grew:
        raise SystemExit(1)


def _frontend_mutate(args, g, idx, fe, us) -> None:
    """Edge-churn replay through the frontend's epoch swap barrier."""
    m_batch = max(1, int(g.m * args.churn))
    print(f"\n[mutate] {args.mutate} batches x {m_batch} edges through "
          f"the frontend swap barrier")
    shapes0 = len(fe.stats()["unique_shapes"])
    recompiles = 0
    for i in range(args.mutate):
        rep, t_repair = _churn_step(args, g, idx, i, m_batch)
        sw = fe.swap_index(idx, rep.graph, affected=rep.affected)
        recompiles += sw["recompiles"]
        g = rep.graph
        tickets = [fe.submit_source(int(u)) for u in us[:args.batch]]
        fe.flush()
        fe.drain(timeout=120.0)
        sample = tickets[0].result(timeout=10.0)[:3]
        print(f"[mutate {i}] repair={t_repair * 1e3:.0f}ms "
              f"swap={sw['swap_ms']:.1f}ms barrier_batches="
              f"{sw['barrier_batches']} recompiles={sw['recompiles']} "
              f"epoch={sw['epoch']} "
              f"sample={np.round(np.asarray(sample), 4)}")
    grew = len(fe.stats()["unique_shapes"]) - shapes0
    _swap_verdict(f"{args.mutate} swaps through the barrier", recompiles,
                  grew)


def _churn_step(args, g, idx, i: int, m_batch: int):
    """The i-th seeded churn batch of m_batch edges, repaired into idx
    in place: returns (UpdateReport, repair seconds)."""
    delta = update.random_delta(g, n_add=m_batch // 2,
                                n_del=m_batch - m_batch // 2,
                                seed=args.seed + 100 + i)
    t0 = time.perf_counter()
    rep = build.update_index(idx, g, delta, seed=args.seed + i,
                             theta_r=args.theta_r)
    return rep, time.perf_counter() - t0


def _swap_verdict(head: str, recompiles: int, grew: int) -> None:
    ok = grew == 0 and not recompiles
    print(f"[mutate] {head}, {recompiles} bucket growths, {grew} new "
          f"shapes ({'fixed-shape swap OK' if ok else 'BUCKETS GREW'})")


def _mutate_replay(args, g, idx, eng, qs) -> None:
    """Edge-churn replay: update -> hot-swap -> serve, N times."""
    m_batch = max(1, int(g.m * args.churn))
    print(f"\n[mutate] {args.mutate} batches x {m_batch} edges "
          f"(churn {args.churn:.2%}), theta_r="
          f"{args.theta_r if args.theta_r is not None else 'plan.theta'}")
    shapes0 = len(eng.stats()["unique_shapes"])
    for i in range(args.mutate):
        rep, t_repair = _churn_step(args, g, idx, i, m_batch)
        sw = eng.swap_index(idx, rep.graph, affected=rep.affected)
        g = rep.graph
        scores = eng.single_source(qs[:args.batch])
        trigger = " REBUILD-TRIGGER" if rep.needs_rebuild else ""
        print(f"[mutate {i}] touched={len(rep.touched)} "
              f"rows={rep.rows_repaired} d={rep.d_updated} "
              f"repair={t_repair * 1e3:.0f}ms swap={sw['swap_ms']:.1f}ms "
              f"dropped={sw['cache_dropped']} "
              f"stale={rep.stale:.4f}/{rep.eps_stale:.4f}{trigger} "
              f"sample={np.round(scores[0][:3], 4)}")
        if rep.needs_rebuild:
            t0 = time.perf_counter()
            idx = build.build_index(g, eps=args.eps, seed=args.seed,
                                    stale_frac=args.stale_frac,
                                    device=args.device)
            eng.swap_index(idx, g)      # full invalidation: epoch 0
            print(f"[mutate {i}] full rebuild in "
                  f"{time.perf_counter() - t0:.1f}s, engine re-armed")
    st = eng.stats()
    grew = len(st["unique_shapes"]) - shapes0
    _swap_verdict(f"{st['swaps']} swaps, last {st['last_swap_ms']:.1f}ms",
                  st["swap_recompiles"], grew)


if __name__ == "__main__":
    main()
