"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch smollm-135m --device cpu --steps 3
    python -m repro_torch.launch.train --arch xdeepfm --device cpu --steps 3
    python -m repro_torch.launch.train --arch gcn-cora --device cpu --steps 3
    python -m repro_torch.launch.train --arch xdeepfm --full --batch 65536

The smoke config by default, the full one with ``--full``; on ``cuda``
unless ``--device cpu``. As the reference: parameters from a generator
seeded 0, ``AdamW(lr=cosine_schedule(lr, 10, steps))`` and ``fit``,
which checkpoints to ``--ckpt-dir`` and resumes from it; an LM on
``TokenStream`` batches of ``--batch`` x ``--seq``, xDeepFM on
``RecsysStream`` batches, a GNN on one full batch of
``barabasi_albert(256, 3)`` (``gnn_batch``; for graphcast half the
nodes grid, half mesh, with seeded g2m / m2g edges and targets). The
loss of every step is logged, where the reference logs every tenth.
An LM's ``--seq`` must be a multiple of its ``loss_chunk``: the full
configs' is 512, so ``--full`` with the default ``--seq 64`` exits
naming it before any parameter is made (the reference fails
``lm_loss``'s assertion at its first step).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import TrainerConfig, fit


def gnn_graph_batch(cfg) -> dict:
    """The reference CLI's GNN batch: ``gnn_batch`` of
    ``barabasi_albert(256, 3)``, and for graphcast the grid / mesh split
    with its seeded g2m and m2g edges and regression targets."""
    from repro_torch.graph import generators
    g = generators.barabasi_albert(256, 3, seed=0, directed=False)
    batch = pipeline.gnn_batch(g, cfg.d_in, max(cfg.n_classes, 1))
    if cfg.kind == "graphcast":
        rng = np.random.default_rng(0)
        n = g.n
        batch.update({
            "n_grid": np.int32(n // 2),
            "g2m_src": rng.integers(0, n // 2, n).astype(np.int32),
            "g2m_dst": rng.integers(n // 2, n, n).astype(np.int32),
            "g2m_mask": np.ones(n, np.float32),
            "m2g_src": rng.integers(n // 2, n, n).astype(np.int32),
            "m2g_dst": rng.integers(0, n // 2, n).astype(np.int32),
            "m2g_mask": np.ones(n, np.float32),
            "targets": np.random.default_rng(1).normal(
                size=(n, cfg.n_vars)).astype(np.float32),
        })
    return batch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="full config (default smoke)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    try:
        spec = cfg_base.get(args.arch)
    except KeyError as e:
        raise SystemExit(str(e))
    if spec.family not in ("lm", "gnn", "recsys"):
        raise SystemExit(f"family {spec.family} has no train entrypoint")
    cfg = spec.full() if args.full else spec.smoke()
    if spec.family == "lm":
        from repro_torch.models import transformer as T
        try:
            T.loss_chunk_of(cfg, args.seq)
        except ValueError as e:
            raise SystemExit(f"--seq {args.seq}: {e}")
    dev = resolve_device(args.device)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=10, total=args.steps))
    # every step's loss, where the reference logs every tenth
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         log_every=1)

    gen = torch.Generator(device=dev).manual_seed(0)
    if spec.family == "lm":
        stream = pipeline.TokenStream(cfg.vocab, args.batch, args.seq)
        fit(lambda p, b: T.lm_loss(cfg, p, b["tokens"], b["targets"]),
            T.init_params(cfg, gen), stream.batch_at, opt, tcfg)
        return
    if spec.family == "gnn":
        from repro_torch.models import gnn as G
        batch = gnn_graph_batch(cfg)
        fit(lambda p, b: G.loss_fn(cfg, p, b), G.init_params(cfg, gen),
            lambda step: batch, opt, tcfg)
        return
    from repro_torch.models import recsys as R
    stream = pipeline.RecsysStream(cfg.n_fields, cfg.vocab_per_field,
                                   args.batch, cfg.multi_hot_fields,
                                   cfg.bag_size)
    fit(lambda p, b: R.loss_fn(cfg, p, b), R.init_params(cfg, gen),
        stream.batch_at, opt, tcfg)


if __name__ == "__main__":
    main()
