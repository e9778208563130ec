"""Where the partitioned MoE prefill's float32 routing leaves the
gathered step's on the card: mixtral-8x22b at its published widths cut
to 2 layers, prefill of B = 2 x 4,096 on a (2, 2) ("data", "model")
mesh of the card, EP and TP (``chip_smoke.MOE_MESH_TP``), every
router call of both steps recorded.

    PYTHONPATH=src:. python scripts/moe_route_probe.py

One line a (placement, layer): whether layer l's K cache is equal bit
for bit; then a line a group: whether the router's input is, its
largest relative difference, the largest difference of the router's
probabilities, the tokens whose k experts differ and the gathered
step's margin between its k-th and (k+1)-th probability at each. Needs
one card (~1 min).
"""
from __future__ import annotations

import dataclasses

import torch

import chip_smoke as C
from repro_torch.configs import base as cfg_base
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import sharding as sh
from repro_torch.launch.specs import lm_rules
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models import transformer_sharded as TS


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = C.card_mesh((2, 2), ("data", "model"), dev)
    cfg = dataclasses.replace(cfg_base.get("mixtral-8x22b").full(),
                              n_layers=2, dtype=torch.float32)
    params = C.lm_params(cfg, dev)
    tokens = torch.as_tensor(TokenStream(cfg.vocab, 2, 4096, seed=6)
                             .batch_at(0)["tokens"], device=dev)
    k = cfg.moe_top_k
    seen, real = [], moe.dispatch

    def spy(x, *a, **kw):
        route = real(x, *a, **kw)
        seen.append((x.detach().clone(), route.probs.detach().clone(),
                     route.expert_idx.detach().clone()))
        return route
    moe.dispatch = spy
    print(C.card_line())
    for rules in (None, C.MOE_MESH_TP):
        with sh.use_mesh_rules(mesh, lm_rules("prefill", 2, rules)):
            _, rc = T.prefill(cfg, params, tokens)
            ref = seen[:]
            seen.clear()
            _, mc = TS.prefill(cfg, TS.place_params(params), tokens)
            part = seen[:]
            seen.clear()
        got = mc["k"].gather(dev)
        for l in range(2):
            print(f"rules {rules} layer {l}: K cache equal "
                  f"{torch.equal(got[l], rc['k'][l])}")
            for g in range(2):
                xr, pr, er = ref[l * 2 + g]
                xp, pp, ep = part[(l * 2 + g) * 2]
                moved = (ep.sort(-1).values != er.sort(-1).values).any(-1)
                top = pr.sort(-1, descending=True).values
                margin = top[:, k - 1] - top[:, k]
                print(f"  group {g}: router input equal "
                      f"{torch.equal(xr, xp)}, largest relative difference "
                      f"{float((xr - xp).abs().max() / xr.abs().max()):.3g};"
                      f" probabilities' largest difference "
                      f"{float((pr - pp).abs().max()):.3g}; tokens sent to "
                      f"other experts {int(moved.sum())}, the gathered "
                      f"step's margins there "
                      f"{[float(m) for m in margin[moved]]}", flush=True)
    moe.dispatch = real


if __name__ == "__main__":
    main()
