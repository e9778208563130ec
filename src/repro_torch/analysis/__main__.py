"""``python -m repro_torch.analysis``: run every slinglint pass over the
port, gate on new findings.

Port of ``repro/analysis/__main__.py``: the same flags and exit codes.
Exit status is 1 iff any finding is absent from the baseline
(``--baseline ANALYSIS_BASELINE_TORCH.json``; no baseline file means
every finding is new), 2 on a bad suppression comment.
``--update-baseline`` rewrites the baseline from the current run
(idempotent: running it twice writes identical bytes).

The reference forces two host devices through ``XLA_FLAGS`` before jax
starts; the port's sharded programs run on two fake devices, which need
no setting.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="slinglint: repo-wide static invariant analyzer "
                    "over the port")
    ap.add_argument("--baseline", default=None, metavar="JSON",
                    help="known-findings file; only findings not in "
                         "it fail the run")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from this run's findings "
                         "and exit 0")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--only", default=None,
                    help="comma list of pass ids (default: all)")
    args = ap.parse_args(argv)

    from repro_torch import analysis
    passes = analysis.all_passes()
    if args.only:
        want = {s.strip() for s in args.only.split(",")}
        unknown = want - set(analysis.PASS_IDS)
        if unknown:
            ap.error(f"unknown pass id(s) {sorted(unknown)}; "
                     f"known: {list(analysis.PASS_IDS)}")
        passes = [p for p in passes if p.pass_id in want]

    try:
        report = analysis.run_repo(passes)
    except ValueError as e:      # bad suppression comment etc.
        print(f"slinglint: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        if not args.baseline:
            ap.error("--update-baseline requires --baseline PATH")
        analysis.save_baseline(args.baseline, report.findings)
        print(f"slinglint: wrote {len(report.findings)} baseline "
              f"entr{'y' if len(report.findings) == 1 else 'ies'} "
              f"to {args.baseline}")
        return 0

    baseline = (analysis.load_baseline(args.baseline)
                if args.baseline else set())
    new = report.new_findings(baseline)

    if args.json:
        print(json.dumps({
            "findings": [f.to_json() for f in report.findings],
            "new": [f.to_json() for f in new],
            "suppressed": len(report.suppressed),
            "skipped": report.skipped,
        }, indent=2, sort_keys=True))
    else:
        for f in report.findings:
            tag = "NEW" if f.ident not in baseline else "baselined"
            print(f"{f.file}:{f.line}: [{f.pass_id}] {f.message} "
                  f"({tag})")
        for pid, reason in sorted(report.skipped.items()):
            print(f"slinglint: skipped {pid}: {reason}")
        print(f"slinglint: {len(report.findings)} finding(s), "
              f"{len(new)} new, {len(report.suppressed)} suppressed, "
              f"{len(report.skipped)} pass(es) skipped")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
