"""Time the GNN train steps of two trees of the port on one card, in
turns, on the same inputs.

    python scripts/gnn_step_compare.py OLD_TREE NEW_TREE [--order 0,1,1,0]

Each tree is the root of a checkout (``OLD_TREE/src/repro_torch``); a
tree is run in a process of its own (both import ``repro_torch``), in
the order given. A run measures, with inputs drawn from fixed seeds
(numpy, and a seeded generator on the card for the minibatch features)
so that every tree run on one machine sees the same numbers, the cells
of ``chip_smoke.py`` phase 3k:

  * full_graph_sm: gcn-cora, gat-cora and pna at ``full()`` with d_in =
    1,433 on ``barabasi_albert(2708, 2)``, graphcast on phase 3k's
    layout over a ``grid2d(52, 52)`` mesh: one warm-up and 5 timed
    ``gnn_train_step``s by CUDA events, the p50;
  * minibatch_lg: ``sample_subgraph`` of ``paper_scale("Enron")`` with
    1,024 seeded seeds, fanout (15, 10) and the cell's pads, uniform
    over the in-neighbours (phase 3k weights them by the join's
    ``KnnGraph``; the shapes and the pad count are alike), then
    gcn-cora, gat-cora and pna with d_in = 602: one warm-up and 3 timed
    steps, the p50, and one more step traced by ``torch.profiler``: its
    device time and its top kernels by self device time.

It prints one JSON line a run and a summary, and writes every run to
``build/gnn_step_compare.json``. It needs a CUDA card; it imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FULL_STEPS, LG_STEPS = (1, 5), (1, 3)


def worker(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import base as cfg_base
    from repro_torch.data.pipeline import gnn_batch
    from repro_torch.graph import generators
    from repro_torch.graph.sampler import sample_subgraph
    from repro_torch.models import gnn as G
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import gnn_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def steps(arch, d_in, batch, counts, trace):
        cfg = dataclasses.replace(cfg_base.get(arch).full(), d_in=d_in)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = G.init_params(cfg, gen)
        opt = AdamW(lr=1e-3)
        state = opt.init(params)
        step = gnn_train_step(cfg, opt)
        ms = []
        for k in range(sum(counts)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            params, state, m = step(params, state, batch)
            float(m["loss"])
            b.record()
            b.synchronize()
            if k >= counts[0]:
                ms.append(a.elapsed_time(b))
        out = {"p50": float(np.percentile(ms, 50))}
        if trace:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, state, m = step(params, state, batch)
                torch.cuda.synchronize()
            rows = [(r.key, r.self_device_time_total / 1e3)
                    for r in prof.key_averages()
                    if r.device_type == DeviceType.CUDA]
            rows.sort(key=lambda kv: -kv[1])
            out["device_ms"] = round(sum(t for _, t in rows), 3)
            out["top"] = [[k[:70], round(t, 3)] for k, t in rows[:5]]
        return out

    res = {"tree": tree}
    gs = generators.barabasi_albert(2708, 2, seed=0, directed=False)
    for arch in ("gcn-cora", "gat-cora", "pna"):
        cfg = cfg_base.get(arch).full()
        res[f"full_graph_sm/{arch}"] = steps(
            arch, 1433, on_card(gnn_batch(gs, 1433, cfg.n_classes)),
            FULL_STEPS, False)
    gm = generators.grid2d(52, 52)
    n = gm.n
    rng = np.random.default_rng(0)
    res["full_graph_sm/graphcast"] = steps("graphcast", 1433, on_card({
        "feats": rng.normal(size=(2 * n, 1433)).astype(np.float32),
        "edge_src": (gm.edge_src + n).astype(np.int32),
        "edge_dst": (gm.edge_dst + n).astype(np.int32),
        "edge_mask": np.ones(gm.m, np.float32),
        "node_mask": np.ones(2 * n, np.float32),
        "n_grid": np.int32(n),
        "g2m_src": rng.integers(0, n, 2 * n).astype(np.int32),
        "g2m_dst": rng.integers(n, 2 * n, 2 * n).astype(np.int32),
        "g2m_mask": np.ones(2 * n, np.float32),
        "m2g_src": rng.integers(n, 2 * n, 2 * n).astype(np.int32),
        "m2g_dst": rng.integers(0, n, 2 * n).astype(np.int32),
        "m2g_mask": np.ones(2 * n, np.float32),
        "targets": rng.normal(size=(2 * n, 227)).astype(np.float32)}),
        FULL_STEPS, False)

    g = generators.paper_scale("Enron", seed=0)
    rng = np.random.default_rng(11)
    seeds = rng.choice(g.n, 1024, replace=False)
    sub = sample_subgraph(g, seeds, (15, 10), rng, 169_984, 168_960)
    res["minibatch_lg/N_M"] = [int(sub.node_mask.sum()),
                               int(sub.edge_mask.sum())]
    gen = torch.Generator(device=dev).manual_seed(12)
    for arch in ("gcn-cora", "gat-cora", "pna"):
        batch = on_card({"edge_src": sub.edge_src, "edge_dst": sub.edge_dst,
                         "edge_mask": sub.edge_mask,
                         "node_mask": sub.node_mask})
        batch["feats"] = torch.randn((169_984, 602), generator=gen,
                                     device=dev)
        batch["labels"] = torch.randint(
            0, cfg_base.get(arch).full().n_classes, (169_984,),
            generator=gen, device=dev, dtype=torch.int32)
        res[f"minibatch_lg/{arch}"] = steps(arch, 602, batch, LG_STEPS,
                                            True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gnn_step_compare needs a CUDA card", file=sys.stderr)
        return 1
    runs = []
    for i in (int(x) for x in args.order.split(",")):
        out = subprocess.run([sys.executable, __file__, "--worker",
                              args.trees[i]], capture_output=True,
                             text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1][7:]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    for k, v in runs[0].items():
        if isinstance(v, dict):
            print(f"{k} step p50 ms: " + " | ".join(
                f"{r['tree']} {r[k]['p50']:.3f}" for r in runs))
    out_dir = Path(__file__).resolve().parents[1] / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gnn_step_compare.json").write_text(
        json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
