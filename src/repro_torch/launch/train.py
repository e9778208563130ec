"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``repro/launch/train.py``, its recsys branch).

    python -m repro_torch.launch.train --arch xdeepfm --device cpu --steps 3
    python -m repro_torch.launch.train --arch xdeepfm --full --batch 65536

The smoke config by default, the full one with ``--full``; on ``cuda``
unless ``--device cpu``. As the reference: parameters from a generator
seeded 0, ``RecsysStream`` batches, ``AdamW(lr=cosine_schedule(lr, 10,
steps))`` and ``fit``, which checkpoints to ``--ckpt-dir`` and resumes
from it. The loss of every step is logged, where the reference logs
every tenth. The LM and GNN families are not ported yet.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import TrainerConfig, fit

NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1, item 3)"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="full config (default smoke)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    try:
        spec = cfg_base.get(args.arch)
    except KeyError:
        raise SystemExit(f"arch {args.arch} {NOT_PORTED}; the port has "
                         f"{sorted(cfg_base.all_archs())}")
    if spec.family in ("lm", "gnn"):
        raise SystemExit(f"family {spec.family} {NOT_PORTED}")
    if spec.family != "recsys":
        raise SystemExit(f"family {spec.family} has no train entrypoint")
    dev = resolve_device(args.device)
    cfg = spec.full() if args.full else spec.smoke()
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=10, total=args.steps))
    # every step's loss, where the reference logs every tenth
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         log_every=1)

    from repro_torch.models import recsys as R
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    stream = pipeline.RecsysStream(cfg.n_fields, cfg.vocab_per_field,
                                   args.batch, cfg.multi_hot_fields,
                                   cfg.bag_size)
    fit(lambda p, b: R.loss_fn(cfg, p, b), params, stream.batch_at, opt,
        tcfg)


if __name__ == "__main__":
    main()
