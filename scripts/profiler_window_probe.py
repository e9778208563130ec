"""How often ``torch.profiler`` keeps no record of a short window on the
card, and whether the kernel records it keeps sit inside the window.

Each window profiles one call of a CIN gradient kernel (dx0 or dW at
B = 512, h = 200, h' = 200, D = 10, as ``tests/test_torch_cuda.py``'s
``_cin_kernel_modes`` does). Per variant it prints how many windows
held no event at all, how many held events but no cin kernel, and, for
the kernel records kept, where the kernel's start lies against the host
clock read just before the call (``time.time_ns()``; Kineto's
timestamps are on the same wall clock). Variants: the CUDA activity
alone (the test's), CPU and CUDA, and the CUDA activity with the host
asleep inside the window before or after the call.

    python scripts/profiler_window_probe.py [--windows 40] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us()
                                                           * 1000)


def window(fn, args, activities, pre_s=0.0, post_s=0.0) -> dict:
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if pre_s:
            time.sleep(pre_s)
        t_call = time.time_ns()
        fn(*args)
        torch.cuda.synchronize()
        t_done = time.time_ns()
        if post_s:
            time.sleep(post_s)
    raw = prof.profiler.kineto_results.events()
    names = [e.name for e in prof.events()]
    kern = [e for e in raw if "cin_" in e.name()]
    out = {"events": len(names), "raw": len(raw),
           "kernel": any("cin_" in n for n in names),
           "names": sorted(set(names))[:8]}
    if kern:
        out["start_us"] = (_start_ns(kern[0]) - t_call) / 1e3
        out["call_us"] = (t_done - t_call) / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--out")
    a = ap.parse_args()
    import test_torch_cuda as T
    card = torch.device("cuda")
    args = T._grad_case(200, 512, 39, 200, 200, 10, card)
    fns = (T.cin_grad_x0, T.cin_grad_w)
    for fn in fns:
        fn(*args)
    torch.cuda.synchronize()
    cuda, cpu = [ProfilerActivity.CUDA], [ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]
    variants = {"cuda": (cuda, 0.0, 0.0), "cpu+cuda": (cpu, 0.0, 0.0),
                "cuda, 20 ms asleep before": (cuda, 0.02, 0.0),
                "cuda, 20 ms asleep after": (cuda, 0.0, 0.02)}
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": torch.cuda.get_device_name(0), "variants": {}}
    for name, (acts, pre, post) in variants.items():
        ws = [window(fns[i % 2], args, acts, pre, post)
              for i in range(a.windows)]
        starts = sorted(w["start_us"] for w in ws if "start_us" in w)
        row = {"windows": len(ws),
               "empty": [i for i, w in enumerate(ws) if not w["events"]],
               "no_kernel": [i for i, w in enumerate(ws)
                             if w["events"] and not w["kernel"]],
               "kernel_start_us_min_med_max":
                   [starts[0], starts[len(starts) // 2], starts[-1]]
                   if starts else None,
               "examples": [w for w in ws if not w["kernel"]][:3]}
        report["variants"][name] = row
        print(f"{name}: {len(row['empty'])} of {len(ws)} windows empty, "
              f"{len(row['no_kernel'])} with events but no cin kernel; "
              f"kept kernels start (us after the call, min/med/max) "
              f"{row['kernel_start_us_min_med_max']}; examples "
              f"{row['examples']}", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
