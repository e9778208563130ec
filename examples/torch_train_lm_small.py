"""Train a small LM (the smollm-135m family's reduced config) for a few
hundred steps with checkpoint/restart enabled, on the PyTorch port.

    PYTHONPATH=src python examples/torch_train_lm_small.py \
        [--steps 300] [--device D]

Everything runs on ``--device`` (``cuda`` by default): ``TokenStream``
batches of 16 x 64, AdamW with a cosine schedule, a checkpoint every
100 steps into a temporary directory. The loss must fall.
"""
import argparse
import tempfile

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import TrainerConfig, fit


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfg_base.get("smollm-135m").smoke()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {cfg.name}, {n_params / 1e3:.0f}K params")

    stream = pipeline.TokenStream(vocab=cfg.vocab, batch=16, seq=64)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=20, total=args.steps))
    with tempfile.TemporaryDirectory() as ckpt:
        params, _, hist = fit(
            lambda p, b: T.lm_loss(cfg, p, b["tokens"], b["targets"]),
            params, stream.batch_at, opt,
            TrainerConfig(steps=args.steps, log_every=50, ckpt_dir=ckpt,
                          ckpt_every=100))
    print(f"loss {hist[0][1]:.3f} -> {hist[-1][1]:.3f}")
    if not hist[-1][1] < hist[0][1]:
        raise RuntimeError("the loss did not fall")


if __name__ == "__main__":
    main()
