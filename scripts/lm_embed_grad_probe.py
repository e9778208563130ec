"""The bf16 embedding gradient of the LM train step on the card: where
its largest entry sits and how far two runs of the unpartitioned step,
the partitioned step on a (2, 2) mesh of the card and the float32 step
are apart.

    PYTHONPATH=src:. python scripts/lm_embed_grad_probe.py

smollm-135m and gemma3-1b whole, train_4k at B = 8 x 4,096 of
``TokenStream`` (zipf) data, ``chip_smoke.lm_params`` weights; once with
torch's default algorithms and once under
``torch.use_deterministic_algorithms``. One line a run: the row holding
the largest |g| and its token's count in the batch, max |g| of each
step, and their distances in bf16 ulps of max |g| (``chip_smoke.ulps``).
Needs one card (~3 min).
"""
from __future__ import annotations

import dataclasses

import torch

import chip_smoke as C
from repro_torch.configs import base as cfg_base
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.models import transformer_sharded as TS
from repro_torch.train.trainer import value_and_grad


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = C.card_mesh((2, 2), ("data", "model"), dev)
    print(C.card_line())
    for arch in ("gemma3-1b", "smollm-135m"):
        cfg = cfg_base.get(arch).full()
        params = C.lm_params(cfg, dev)
        b = TokenStream(cfg.vocab, 8, 4096, seed=5).batch_at(0)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        count = torch.bincount(batch["tokens"].reshape(-1),
                               minlength=cfg.vocab)

        def whole(c):
            return value_and_grad(
                lambda p, x: T.lm_loss(c, p, x["tokens"], x["targets"]),
                params, batch)[1]["embed"]

        def part(c):
            with sh.use_mesh_rules(mesh):
                leaves = TS.place_params(params)
                _, g = TS.value_and_grad(c, leaves, batch["tokens"],
                                         batch["targets"])
                return C.assembled(leaves["embed"], g["embed"], dev)
        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            u1, u2, p1 = whole(cfg), whole(cfg), part(cfg)
            f32 = whole(dataclasses.replace(cfg, dtype=torch.float32))
            i = int(u1.abs().argmax())
            row = i // u1.shape[1]
            at = [float(t.reshape(-1)[i]) for t in (u1, p1, f32)]
            print(f"{arch} deterministic {det}: largest |g| in row {row} "
                  f"(its token {int(count[row])} times); max |g| "
                  f"unpartitioned {float(u1.abs().max())} and "
                  f"{float(u2.abs().max())}, partitioned "
                  f"{float(p1.abs().max())}, float32 "
                  f"{float(f32.abs().max())}; in bf16 ulps of max |g|, "
                  f"the two unpartitioned runs {C.ulps(u2, u1):.3g} "
                  f"entrywise, partitioned vs unpartitioned "
                  f"{C.ulps(p1.abs().max(), u1.abs().max()):.3g} (max "
                  f"|g|) {C.ulps(p1, u1):.3g} (entrywise), vs float32: "
                  f"unpartitioned {C.ulps(u1, f32):.3g}, partitioned "
                  f"{C.ulps(p1, f32):.3g}; that entry unpartitioned / "
                  f"partitioned / float32 {at}", flush=True)
            del u1, u2, p1, f32
            torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
