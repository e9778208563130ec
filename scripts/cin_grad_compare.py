"""Time the CIN gradient kernels of two trees of the port on one card, in
turns, on the same inputs.

    python scripts/cin_grad_compare.py OLD_TREE NEW_TREE [--order 0,1,1,0]

Each tree is the root of a checkout (``OLD_TREE/src/repro_torch``); a
tree is run in a process of its own (both import ``repro_torch``), in
the order given, and each builds its kernels into its own
``build/kernels``. A run measures, with inputs drawn from fixed seeds
(numpy, and a seeded generator on the card for the train batch) so
that every tree run on one machine sees the same numbers:

  * the three gradient kernels at the serve batch (B = 512, xDeepFM's
    layers 39-200-200-200, m = 39, D = 10, O(1) inputs, g unit normal):
    the sum over the layers by CUDA events, and each kernel's error
    against the plain formulas relative to max |grad|;
  * ``cin_grad_x0`` and ``cin_grad_w`` a layer at the train batch
    (B = 65,536), by CUDA events;
  * one xDeepFM train step at full width (``xdeepfm.full()``, B = 65,536,
    a ``RecsysStream`` batch with mh_ids): forward and backward by CUDA
    events, and the CIN kernels' device time in a profiler trace, by
    kernel name.

It prints one JSON line a run and a summary, and writes every run to
``build/cin_grad_compare.json``. It needs a CUDA card; it imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SERVE_B, TRAIN_B = 512, 65_536
M, D = 39, 10
LAYERS = (39, 200, 200, 200)          # h of layer k is LAYERS[k]


def _inputs(B: int, seed: int):
    """Per layer (x0, xk, W, g) as numpy float32: unit normal x0, xk, g
    and W / sqrt(h*m)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, M, D), dtype=np.float32)
    out = []
    for h, hp in zip(LAYERS[:-1], LAYERS[1:]):
        xk = x0 if h == M else rng.standard_normal((B, h, D),
                                                   dtype=np.float32)
        W = (rng.standard_normal((hp, h, M), dtype=np.float32)
             / np.float32(np.sqrt(h * M)))
        g = rng.standard_normal((B, hp, D), dtype=np.float32)
        out.append((x0, xk, W, g))
    return out


def _events_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def worker(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import xdeepfm
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.kernels import cin as kcin
    from repro_torch.kernels.cin import ref
    from repro_torch.models import recsys
    from repro_torch.train.trainer import to_device, trainable

    dev = torch.device("cuda")
    res = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    names = ("cin_grad_x0", "cin_grad_xk", "cin_grad_w")
    fns = [getattr(kcin, k) for k in names]
    plain = (lambda x0, xk, W, g: ref.cin_grad_x0_plain(xk, W, g),
             lambda x0, xk, W, g: ref.cin_grad_xk_plain(x0, W, g),
             lambda x0, xk, W, g: ref.cin_grad_w_plain(x0, xk, g))
    layers = [tuple(torch.as_tensor(a, device=dev) for a in t)
              for t in _inputs(SERVE_B, 0)]
    with torch.no_grad():
        for k, fn, pl in zip(names, fns, plain):
            err = 0.0
            for a in layers:
                want = pl(*(t.double() for t in a))
                got = fn(*a).double()
                err = max(err, float((got - want).abs().max()
                                     / want.abs().max()))
            res[f"{k}_err_vs_float64"] = err
            res[f"{k}_ms_B512"] = _events_ms(
                lambda: [fn(*a) for a in layers], 20)
    del layers
    # the train batch's inputs from a seeded generator on the card: the
    # same numbers for every tree run on one machine
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for li, (h, hp) in enumerate(zip(LAYERS[:-1], LAYERS[1:])):
            x0 = torch.randn((TRAIN_B, M, D), generator=gen, device=dev)
            xk = x0 if h == M else torch.randn((TRAIN_B, h, D),
                                               generator=gen, device=dev)
            W = torch.randn((hp, h, M), generator=gen,
                            device=dev) / (h * M) ** 0.5
            g = torch.randn((TRAIN_B, hp, D), generator=gen, device=dev)
            for k in ("cin_grad_x0", "cin_grad_w"):
                fn = getattr(kcin, k)
                res[f"{k}_ms_B65536_layer{li + 1}"] = _events_ms(
                    lambda: fn(x0, xk, W, g), 3)
            del x0, xk, W, g
    torch.cuda.empty_cache()

    cfg = xdeepfm.full()
    model = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = trainable(model)
    batch = to_device(RecsysStream(cfg.n_fields, cfg.vocab_per_field,
                                   TRAIN_B, cfg.multi_hot_fields,
                                   cfg.bag_size).batch_at(0), model)

    def step():
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        loss = recsys.loss_fn(cfg, model, batch)
        e[1].record()
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        e[2].record()
        torch.cuda.synchronize()
        del grads
        return e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])

    step()
    times = [step() for _ in range(3)]
    res["step_forward_ms"] = sorted(t[0] for t in times)[1]
    res["step_backward_ms"] = sorted(t[1] for t in times)[1]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
    cin = {}
    for r in prof.key_averages():
        if r.device_type == DeviceType.CUDA and "cin_" in r.key:
            cin[r.key[:90]] = round(r.self_device_time_total / 1e3, 4)
    res["step_cin_kernels_ms"] = cin
    res["step_cin_ms"] = round(sum(cin.values()), 4)
    res["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
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
        print("cin_grad_compare needs a CUDA card", file=sys.stderr)
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
    keys = [k for k, v in runs[0].items()
            if isinstance(v, float) and ("_ms" in k or "_err" in k)]
    for k in keys:
        print(f"{k}: " + " | ".join(f"{r['tree']} {r[k]:.6g}"
                                     for r in runs))
    out_dir = Path(__file__).resolve().parents[1] / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "cin_grad_compare.json").write_text(
        json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
