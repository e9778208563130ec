"""Per-cell inspection: the op walk's totals, collectives and top tensors
(port of ``repro/launch/inspect_cell.py``).

The reference greps a compiled cell's HLO text; the port reads the op
walk of one traced call (``launch/dryrun.py``): the busiest device's
totals, the collective bytes by kind, and the largest results by op,
dtype and shape, with how many ops made one (every call counted: eager
dispatch has no loop bodies to count once).

  PYTHONPATH=src python -m repro_torch.launch.inspect_cell --arch gcn-cora \\
      --shape ogb_products [--multi-pod]
"""
from __future__ import annotations

import argparse
from collections import Counter

from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh


def inspect(arch, shape, multi_pod=False, top=14):
    """Print the walk of one call of the cell's step on the production
    mesh's fake devices; returns (cell, walk)."""
    mesh = make_production_mesh(
        multi_pod=multi_pod,
        devices=dryrun.fake_devices(512 if multi_pod else 256))
    cell = specs.make_cell(arch, shape, mesh)
    w, _ = dryrun.trace_cell(cell)
    print(f"walk: flops {w.flops:.3e} hbm {w.hbm_bytes:.3e} "
          f"coll {w.coll_bytes:.3e}")
    print("coll by op (GB):",
          {k: round(v / 1e9, 2) for k, v in w.coll_by_op.items()})
    if w.kernels:
        print("port kernels:", w.kernels)
    c = Counter()
    sz = {}
    for r in w.records:
        key = f"{r.op} {r.dtype}{list(r.shape)}"
        c[key] += 1
        sz[key] = r.nbytes
    print("--- top tensors (every call counted) ---")
    for key, cnt in sorted(c.items(), key=lambda kv: -sz[kv[0]])[:top]:
        print(f"{sz[key] / 2**20:10.1f} MiB x{cnt:3d}  {key}")
    return cell, w


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    inspect(args.arch, args.shape, args.multi_pod)


if __name__ == "__main__":
    main()
