"""slinglint pass framework: findings, suppressions, baselines.

Port of ``repro/analysis/core.py`` (the port keeps its own copy; it
imports nothing of the reference). The analyzer (DESIGN.md section 14)
is a small pluggable pipeline: passes consume a :class:`Context` (the
parsed repo sources; the dispatch passes ignore it and run the
registered programs instead) and return :class:`Finding` rows. The
runner then

  1. validates every ``# slinglint: disable=<pass-id>`` comment
     (unknown pass ids are refused with ``ValueError`` -- a typo'd
     suppression must not silently suppress nothing),
  2. drops findings suppressed on their own line, and
  3. splits the rest into baselined vs *new* against a checked-in
     baseline (the port's is ``ANALYSIS_BASELINE_TORCH.json``, in the
     reference's format, so a baseline written by either package loads
     in the other); only new findings gate CI.

Baseline identity is ``(pass_id, file, key)`` -- ``key`` is a
line-independent handle chosen by each pass (e.g.
``ServeFrontend._submit:_queues``), so unrelated edits that shift line
numbers never churn the baseline.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path

BASELINE_VERSION = 1

_DISABLE_RE = re.compile(r"#\s*slinglint:\s*disable=([A-Za-z0-9_,\-]+)")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One invariant violation.

    ``key`` is the stable identity within (pass_id, file): baseline
    matching and suppression bookkeeping never depend on ``line``,
    which exists for human navigation only.
    """
    pass_id: str
    file: str                 # repo-relative posix path
    line: int
    key: str
    message: str
    severity: str = "error"   # "error" | "warning"

    @property
    def ident(self) -> tuple:
        return (self.pass_id, self.file, self.key)

    def to_json(self) -> dict:
        return {"pass": self.pass_id, "file": self.file,
                "line": self.line, "key": self.key,
                "message": self.message, "severity": self.severity}


class PassSkipped(RuntimeError):
    """Raised by ``Pass.run`` when its preconditions are absent. The
    runner records the reason in ``Report.skipped`` instead of failing.
    No pass of the port raises it (its collective-contract pass walks a
    mesh of fake devices, which every host has); it stays for parity
    with the reference's framework."""


class Pass:
    """Protocol: subclasses set ``pass_id`` and implement ``run``."""

    pass_id: str = ""

    def run(self, ctx: "Context") -> list[Finding]:
        raise NotImplementedError


@dataclasses.dataclass
class SourceFile:
    path: str                 # repo-relative posix path (display + keys)
    text: str
    _tree: ast.Module | None = dataclasses.field(default=None,
                                                 repr=False)

    def tree(self) -> ast.Module:
        if self._tree is None:
            self._tree = ast.parse(self.text, filename=self.path)
        return self._tree


@dataclasses.dataclass
class Context:
    files: list[SourceFile]
    root: Path

    def file(self, path: str) -> SourceFile:
        for sf in self.files:
            if sf.path == path:
                return sf
        raise KeyError(path)


# ----------------------------------------------------------------------
# suppressions
# ----------------------------------------------------------------------
def scan_suppressions(sf: SourceFile,
                      known_ids: tuple[str, ...]) -> dict[int, set]:
    """line -> set of pass ids disabled on that line.

    Refuses unknown pass ids: a suppression that matches nothing is a
    latent bug (the violation it meant to justify is either gone or
    never covered), so it must fail loudly, not rot.
    """
    out: dict[int, set] = {}
    known = set(known_ids)
    for lineno, line in enumerate(sf.text.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
        unknown = ids - known
        if unknown:
            raise ValueError(
                f"{sf.path}:{lineno}: slinglint disable comment names "
                f"unknown pass id(s) {sorted(unknown)}; known ids: "
                f"{sorted(known)}")
        out[lineno] = ids
    return out


# ----------------------------------------------------------------------
# baseline
# ----------------------------------------------------------------------
def baseline_entries(findings: list[Finding]) -> list[dict]:
    rows = sorted({f.ident for f in findings})
    return [{"pass": p, "file": fp, "key": k} for (p, fp, k) in rows]


def save_baseline(path, findings: list[Finding]) -> None:
    payload = {"version": BASELINE_VERSION,
               "findings": baseline_entries(findings)}
    Path(path).write_text(json.dumps(payload, indent=2,
                                     sort_keys=True) + "\n")


def load_baseline(path) -> set:
    """-> set of (pass_id, file, key) idents; {} for a missing file."""
    p = Path(path)
    if not p.exists():
        return set()
    payload = json.loads(p.read_text())
    ver = payload.get("version")
    if ver != BASELINE_VERSION:
        raise ValueError(f"{path}: baseline version {ver!r}, "
                         f"expected {BASELINE_VERSION}")
    return {(e["pass"], e["file"], e["key"])
            for e in payload.get("findings", [])}


# ----------------------------------------------------------------------
# runner
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Report:
    findings: list[Finding]            # kept (unsuppressed), sorted
    suppressed: list[Finding]
    skipped: dict[str, str]            # pass_id -> reason

    def new_findings(self, baseline: set) -> list[Finding]:
        return [f for f in self.findings if f.ident not in baseline]

    def by_pass(self) -> dict[str, list[Finding]]:
        out: dict[str, list[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.pass_id, []).append(f)
        return out


def run_passes(passes: list[Pass], ctx: Context,
               known_ids: tuple[str, ...]) -> Report:
    """Run passes, apply same-line suppressions, return a Report.

    ``known_ids`` is the full registry (not just the passes being
    run), so running a subset never misreads a valid suppression for
    another pass as unknown.
    """
    supp = {sf.path: scan_suppressions(sf, known_ids)
            for sf in ctx.files}
    kept: list[Finding] = []
    suppressed: list[Finding] = []
    skipped: dict[str, str] = {}
    for p in passes:
        try:
            found = p.run(ctx)
        except PassSkipped as e:
            skipped[p.pass_id] = str(e)
            continue
        for f in found:
            if f.pass_id in supp.get(f.file, {}).get(f.line, ()):
                suppressed.append(f)
            else:
                kept.append(f)
    return Report(findings=sorted(kept), suppressed=sorted(suppressed),
                  skipped=skipped)
