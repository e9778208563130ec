"""The GNNs' dry run on the production meshes, three ways: the
reference's compiled cell, the port's partitioned step, and the port's
gathered step (the unpartitioned step on every argument gathered to the
mesh's first device, the path before the partitioned one).

    PYTHONPATH=src python scripts/gnn_mesh_dryrun.py [--arch A ...]
        [--shape S ...] [--out build/gnn_mesh_dryrun.json]

For each (arch, shape) of gcn-cora, gat-cora, pna and graphcast at the
four GNN shapes, and each mesh (16 x 16, 2 x 16 x 16): the reference's
record from its own CLI in a subprocess (cached in ``--ref-cache``), the
port's two from
``launch/dryrun``'s walk on fake devices (``scripts/lm_mesh_dryrun.py``'s
``reference``, ``gathered`` and ``row``). It prints one JSON row a
record (the busiest device's ``peak_est`` and collective bytes in each,
the port's FLOPs against the gathered step's, the collective kinds),
then a table, and checks the partitioned step's bars: no "gather", the
reference's argument bytes, a peak under 80 GiB, collective bytes at
most 4 x the reference's, FLOPs x the device count at most 2 x the
gathered step's. Writes the rows as JSON to ``--out``; exits 1 if a
bar fails. Runs on the CPU, no card.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

from lm_mesh_dryrun import ROOT, gathered, reference, row

ARCHS = ("gcn-cora", "gat-cora", "pna", "graphcast")
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
PEAK_GIB, COLL_OVER_REF, FLOPS_OVER_GATHERED = 80.0, 4.0, 2.0


def bars(r: dict) -> list:
    """The bars ``r`` fails, by name."""
    bad = []
    if re.search(r"(^| )gather:", r["after_collectives"]):
        bad.append("gather")
    if r["arg_bytes"] != r["ref_arg_bytes"]:
        bad.append("argument bytes")
    if not r["after_peak_gib"] < PEAK_GIB:
        bad.append("peak")
    if not r["coll_after_over_ref"] <= COLL_OVER_REF:
        bad.append("collective bytes")
    if not r["flops_after_over_before_per_dev"] <= FLOPS_OVER_GATHERED:
        bad.append("flops")
    return bad


def table(rows: list) -> str:
    head = ("| cell | mesh | peak GiB ref / gathered / partitioned | "
            "collective MB a device ref / partitioned | partitioned "
            "kinds | FLOPs x n / gathered |\n| --- | --- | --- | --- | "
            "--- | --- |")
    lines = [head]
    for r in rows:
        kinds = " ".join(re.sub(r"\(x\d+\)", "", k)
                         for k in r["after_collectives"].split())
        lines.append(
            f"| {r['arch']} x {r['shape']} | {r['mesh']} | "
            f"{r['ref_peak_gib']:.2f} / {r['before_peak_gib']:.2f} / "
            f"{r['after_peak_gib']:.2f} | {r['ref_coll_mb']:.1f} / "
            f"{r['after_coll_mb']:.1f} | {kinds} | "
            f"{r['flops_after_over_before_per_dev']:.3f} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "gnn_mesh_dryrun.json"))
    ap.add_argument("--ref-cache", default=str(ROOT / "build" /
                                               "dryrun_ref"),
                    help="a directory of the reference's records, read "
                         "where present and written where not")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    rows, failed, t0 = [], [], time.perf_counter()
    for arch in args.arch:
        for shape in args.shape:
            refs = reference(arch, shape, Path(args.ref_cache))
            for mp in (False, True):
                n_dev = 512 if mp else 256
                mesh = make_production_mesh(
                    multi_pod=mp, devices=dryrun.fake_devices(n_dev))
                part = dryrun.run_cell(arch, shape, mesh=mesh,
                                       verbose=False)
                old = gathered(arch, shape, mesh)
                r = row(arch, shape, part["mesh"], n_dev,
                        refs[part["mesh"]], part, old)
                r["bars_failed"] = bars(r)
                if r["bars_failed"]:
                    failed.append((arch, shape, part["mesh"],
                                   r["bars_failed"]))
                rows.append(r)
                print(json.dumps(r), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    print(table(rows))
    print(f"{len(rows)} records in {time.perf_counter() - t0:.1f} s; "
          f"wrote {args.out}; bars failed: {failed or 'none'}")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
