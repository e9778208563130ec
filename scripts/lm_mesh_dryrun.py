"""The LMs' dry run on the production meshes, three ways: the
reference's compiled cell, the port's partitioned step, and the port's
gathered step (the unpartitioned step on every argument gathered to the
mesh's first device, the path before the partitioned one).

    PYTHONPATH=src python scripts/lm_mesh_dryrun.py [--arch A ...]
        [--shape S ...] [--out build/lm_mesh_dryrun.json]

For each (arch, shape) of smollm-135m, gemma3-1b, qwen3-14b,
mixtral-8x22b and llama4-scout-17b-a16e at the four LM shapes, and each
mesh (16 x 16, 2 x 16 x 16): the reference's
record comes from its own CLI in a subprocess (``python -m
repro.launch.dryrun --both-meshes --out ...``, 512 forced host devices;
this script imports nothing of JAX), the port's two from
``launch/dryrun``'s walk on fake devices. It prints one row a record:
the busiest device's ``peak_est`` and collective bytes in each (and
the ratios to the reference's), the port's walked FLOPs against the
gathered step's (summed over its devices) over the device count, the
collective kinds, and the seconds each trace took; and writes the rows
as JSON to ``--out``. Runs on the CPU, no card; the 24 dense records
take about half an hour.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("smollm-135m", "gemma3-1b", "qwen3-14b", "mixtral-8x22b",
         "llama4-scout-17b-a16e")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def reference(arch: str, shape: str, cache: Path | None = None) -> dict:
    """{mesh: the reference's record} of one cell, both meshes; read from
    ``cache`` (a directory) where an earlier call wrote it there (the
    reference does not change)."""
    hit = None if cache is None else cache / f"{arch}__{shape}.json"
    if hit is not None and hit.exists():
        return {r["mesh"]: r for r in json.loads(hit.read_text())}
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "ref.json"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(ROOT / "src"))
        subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--both-meshes",
                        "--out", str(out)], check=True, env=env, cwd=ROOT,
                       capture_output=True)
        text = out.read_text()
    if hit is not None:
        hit.parent.mkdir(parents=True, exist_ok=True)
        hit.write_text(text)
    return {r["mesh"]: r for r in json.loads(text)}


def unpartitioned(arch: str, shape: str):
    """The unpartitioned step of ``arch`` x ``shape``'s cell: the LM's
    train (AdamW lr 1e-4), prefill or decode step, or the GNN's train
    step (AdamW lr 1e-3, d_in the shape's d_feat), as the cells make
    them."""
    from repro_torch.configs import base
    from repro_torch.launch import specs
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import steps

    spec = base.get(arch)
    if spec.family == "gnn":
        cfg = dataclasses.replace(
            spec.full(), d_in=specs.GNN_SHAPE_DEFS[shape]["d_feat"])
        return steps.gnn_train_step(cfg, AdamW(lr=1e-3))
    cfg = spec.full()
    kind = specs.LM_SHAPE_DEFS[shape]["kind"]
    return {"train": lambda: steps.lm_train_step(cfg, AdamW(lr=1e-4)),
            "prefill": lambda: steps.lm_prefill_step(cfg),
            "decode": lambda: steps.lm_decode_step(cfg)}[kind]()


def gathered(arch: str, shape: str, mesh) -> dict:
    """The gathered step's walk on ``mesh``: the cell with its step
    replaced by the unpartitioned one and nothing read as pieces."""
    from repro_torch.launch import dryrun, specs

    t0 = time.perf_counter()
    cell = specs.make_cell(arch, shape, mesh)
    walk, _ = dryrun.trace_cell(dataclasses.replace(
        cell, fn=unpartitioned(arch, shape), piecewise=()))
    mem = {"argument": walk.arg_bytes, "output": walk.out_bytes,
           "alias": walk.alias_bytes}
    temp = max(0.0, walk.peak_bytes - mem["argument"] - mem["output"]
               + mem["alias"])
    # its FLOPs over every device: the MoE layer's mesh branch runs each
    # group's experts on that group's device
    return {"peak_est": mem["argument"] + temp + mem["output"]
            - mem["alias"],
            "flops": sum(c.flops for c in walk.devices.values()),
            "coll_bytes": walk.coll_bytes, "coll_by_op": walk.coll_by_op,
            "t_s": time.perf_counter() - t0}


def row(arch, shape, mesh_name, n_dev, ref, part, old) -> dict:
    gib = 2.0 ** 30
    r_peak = ref["bytes_per_device"]["peak_est"]
    p_peak = part["bytes_per_device"]["peak_est"]
    r_coll = ref["roofline"]["coll_bytes/dev"]
    p_coll = part["roofline"]["coll_bytes/dev"]
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "arg_bytes": part["bytes_per_device"]["argument"],
        "ref_arg_bytes": ref["bytes_per_device"]["argument"],
        "ref_peak_gib": r_peak / gib, "before_peak_gib": old["peak_est"] / gib,
        "after_peak_gib": p_peak / gib, "after_over_ref": p_peak / r_peak,
        "before_over_ref": old["peak_est"] / r_peak,
        "ref_coll_mb": r_coll / 1e6, "before_coll_mb": old["coll_bytes"] / 1e6,
        "after_coll_mb": p_coll / 1e6,
        "coll_after_over_ref": p_coll / r_coll if r_coll else math.inf,
        "after_flops": part["roofline"]["flops/dev"],
        "before_flops": old["flops"],
        "flops_after_over_before_per_dev":
            part["roofline"]["flops/dev"] * n_dev / old["flops"],
        "ref_collectives": ref["collectives"],
        "after_collectives": part["collectives"],
        "before_coll_by_op_mb": {k: v / 1e6
                                 for k, v in old["coll_by_op"].items()},
        "t_after_s": part["t_lower_s"], "t_before_s": round(old["t_s"], 2),
        "t_ref_s": ref["t_lower_s"] + ref["t_compile_s"],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "lm_mesh_dryrun.json"))
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    rows, t0 = [], time.perf_counter()
    for arch in args.arch:
        for shape in args.shape:
            refs = reference(arch, shape)
            for mp in (False, True):
                mesh = make_production_mesh(
                    multi_pod=mp, devices=dryrun.fake_devices(
                        512 if mp else 256))
                part = dryrun.run_cell(arch, shape, mesh=mesh,
                                       verbose=False)
                old = gathered(arch, shape, mesh)
                n_dev = 512 if mp else 256
                r = row(arch, shape, part["mesh"], n_dev,
                        refs[part["mesh"]], part, old)
                rows.append(r)
                print(json.dumps(r), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    print(f"{len(rows)} records in {time.perf_counter() - t0:.1f} s; "
          f"wrote {args.out}")


if __name__ == "__main__":
    main()
