"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

For every (architecture x input shape) cell, trace the cell's step once
on the production mesh -- 16x16 single-pod and 2x16x16 multi-pod -- and
record what each device would hold and what bounds the step: argument,
output and peak bytes, the op walk's FLOPs, HBM and collective bytes,
and the roofline they give (``launch/hlo_walk.py``,
``launch/hlo_analysis.py``).

The reference lowers and compiles under 512 forced host devices. The
port compiles nothing: it runs the step eagerly once under
``FakeTensorMode``, on a mesh of fake devices (:func:`fake_devices`),
so no tensor is allocated and no card is needed. The arguments are
placed as the cell's ``in_shardings`` say. A step that reads its placed
pieces (the LMs' train, prefill and decode, dense and MoE, the base
GNN's train step, the shardmap GCN, the SLING pod path) runs one program
a mesh position; ``Cell.jitted`` gathers the arguments of every other
step (the recsys steps) to the first device, a gather the walk counts.

Shortcut: the LMs' and the GNNs' partitioned steps on fake tensors over
distinct devices run the programs of two positions for each class of
positions whose programs have equal shapes (the first and the last of
the class, row-major; ``launch/collectives.spmd``), not all 256 or
512, and their collectives book each running device's bytes from the
regions of every position. Each device that runs then holds what it
holds in a trace of every position and every other device its
arguments, so the busiest device's numbers are the full trace's:
``tests/test_torch_lm_mesh.py`` holds the record of every dense-LM
cell kind on a fake (2, 4) mesh equal to the full trace's
(``collectives.every_position``), ``t_lower_s`` and ``n_ops`` aside,
which count the work traced; ``tests/test_torch_gnn_mesh.py`` does the
same for each GNN kind on a fake (4, 4) mesh.

The record keeps the reference's keys. ``t_lower_s`` is the trace:
making the cell, placing its arguments and the walked call;
``t_compile_s`` is 0.0, as there is no compile. ``bytes_per_device``
is the busiest device's: ``argument`` its placed pieces, ``output`` the
step's results on it, ``alias`` the results that share storage with an
argument (a donated one, updated in place), ``peak_est`` the peak of
its live storage during the step, and ``temp`` = peak_est - argument -
output + alias. The port adds ``kernels`` (the port kernels' calls on
the path, each one op at its cost) and ``worst_cases`` (what was taken
for data a fake tensor does not hold).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gcn-cora --shape full_graph_sm
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out results.json]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.kernels import cost as _cost
from repro_torch.launch import hlo_analysis, hlo_walk, specs
from repro_torch.launch.mesh import make_production_mesh


def fake_devices(count: int) -> list:
    """The dry run's stand-ins for ``count`` (at most 512) cards, all
    distinct. Not ``cuda`` devices: a CPU build of torch cannot run
    autograd over fake ``cuda`` tensors, and a CUDA build checks their
    indices against the cards it has. ``meta`` and ``lazy`` run it in
    either build; torch keeps a device's index in 8 bits (its 256
    values, -1 printing as no index), so each type gives 256."""
    devs = [torch.device(t, i) for t in ("meta", "lazy") for i in range(256)]
    if count > len(devs):
        raise ValueError(f"at most {len(devs)} fake devices, asked for "
                         f"{count}")
    return devs[:count]


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape.values())


def trace_cell(cell):
    """(the op walk of one call of ``cell``'s step on its placed fake
    arguments, the seconds it took)."""
    from torch._guards import detect_fake_mode
    mode = detect_fake_mode(hlo_walk.leaf_tensors(cell.args))
    t0 = time.perf_counter()
    with mode:
        placed = cell.place()
    call = cell.jitted()
    walk = hlo_walk.analyze(lambda *_: call(*placed),
                            *[p.leaves for p in placed])
    return walk, time.perf_counter() - t0


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             rules: dict | None = None, verbose: bool = True, *,
             mesh=None) -> dict:
    """The dry-run record of one cell on the production mesh (or on
    ``mesh``, whose devices may be fake or the card's)."""
    if mesh is None:
        mesh = make_production_mesh(
            multi_pod=multi_pod, devices=fake_devices(512 if multi_pod
                                                      else 256))
    n_dev = math.prod(mesh.shape.values())
    _cost.worst_cases(clear=True)
    t0 = time.perf_counter()
    cell = specs.make_cell(arch_id, shape_name, mesh, rules)
    walk, _ = trace_cell(cell)
    t_lower = time.perf_counter() - t0
    mem = {"argument": int(walk.arg_bytes), "output": int(walk.out_bytes),
           "alias": int(walk.alias_bytes)}
    mem["temp"] = max(0, int(walk.peak_bytes) - mem["argument"]
                      - mem["output"] + mem["alias"])
    mem["peak_est"] = (mem["argument"] + mem["temp"] + mem["output"]
                       - mem["alias"])
    roof = hlo_analysis.analyze_cell(walk, cell.model_flops, n_dev, mem)
    rec = {
        "arch": arch_id, "shape": cell.shape_name, "mesh": mesh_name(mesh),
        "n_devices": n_dev,
        "ok": True,
        "t_lower_s": round(t_lower, 2), "t_compile_s": 0.0,
        "model_flops": cell.model_flops,
        "bytes_per_device": mem,
        "roofline": roof.row(),
        "collectives": hlo_analysis.collective_stats(walk.records).summary(),
        "kernels": walk.kernels,
        "worst_cases": _cost.worst_cases(clear=True),
        "n_ops": walk.n_ops,
    }
    if verbose:
        bpd = mem["peak_est"] / 2**30
        r = rec["roofline"]
        print(f"[{rec['mesh']}] {arch_id} x {cell.shape_name}: "
              f"trace {t_lower:.1f}s peak~{bpd:.2f}GiB/dev "
              f"t=(c {r['t_compute_s']:.2e}, m {r['t_memory_s']:.2e}, "
              f"x {r['t_collective_s']:.2e}) -> {r['bottleneck']} "
              f"mfu~{r['roofline_mfu']:.3f}", flush=True)
    return rec


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch_id, spec in sorted(cfg_base.all_archs().items()):
        if spec.family == "sling":
            continue  # extra cell, run explicitly
        for shape in spec.shapes:
            out.append((arch_id, shape))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch_id, shape in cells:
        for mp in meshes:
            try:
                results.append(run_cell(arch_id, shape, multi_pod=mp))
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                results.append({"arch": arch_id, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "ok": False, "error": str(e)[:500]})
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells traced OK")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
