"""slinglint: repo-wide static invariant analyzer over the port
(port of ``repro/analysis``; DESIGN.md §14).

Three pass families at three layers, under the reference's six pass ids
(in its order, so a ``# slinglint: disable=`` comment means the same in
both packages):

  * AST (``ast_passes``): lock discipline over declared guarded
    fields, clock-seam purity, banned APIs -- the reference's rules.
  * dispatch (``jaxpr_passes``; the reference traces jaxprs): each
    registered program (``programs``) runs once under a dispatch mode
    that records host syncs -- the dispatch boundary's counterpart of a
    host callback at a jit boundary -- and shapes outside their buckets;
    the frontier-sized HBM-intermediate budgets count the op walk's
    writes (``launch/hlo_walk.py``).
  * collectives (``hlo_passes``; the reference parses compiled HLO):
    the sharded fan-out's copies between devices, as the op walk counts
    them on a mesh of two fake devices, hold the psum row fetch +
    frontier all-gather contract.

Run everything: ``python -m repro_torch.analysis --baseline
ANALYSIS_BASELINE_TORCH.json`` (exit non-zero on findings not in the
baseline). Nothing needs a card or a forced device count.
"""
from __future__ import annotations

import inspect
from pathlib import Path

from repro_torch.analysis.core import (BASELINE_VERSION,  # noqa: F401
                                       Context, Finding, Pass, PassSkipped,
                                       Report, SourceFile, baseline_entries,
                                       load_baseline, run_passes,
                                       save_baseline, scan_suppressions)

PASS_IDS = ("lock-discipline", "clock-seam", "banned-api",
            "jit-boundary", "hbm-budget", "collective-contract")


def all_passes() -> list[Pass]:
    """One instance of every registered pass, AST families first."""
    from repro_torch.analysis.ast_passes import (BannedApiPass,
                                                 ClockSeamPass,
                                                 LockDisciplinePass)
    from repro_torch.analysis.hlo_passes import CollectiveContractPass
    from repro_torch.analysis.jaxpr_passes import (HbmBudgetPass,
                                                   JitBoundaryPass)
    passes = [LockDisciplinePass(), ClockSeamPass(), BannedApiPass(),
              JitBoundaryPass(), HbmBudgetPass(),
              CollectiveContractPass()]
    assert tuple(p.pass_id for p in passes) == PASS_IDS
    return passes


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def repo_context(root: Path | None = None) -> Context:
    """Parse every .py file under src/repro_torch into a Context."""
    root = Path(root) if root else repo_root()
    files = []
    for p in sorted((root / "src" / "repro_torch").rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        files.append(SourceFile(path=rel, text=p.read_text()))
    return Context(files=files, root=root)


def run_repo(passes: list[Pass] | None = None,
             root: Path | None = None) -> Report:
    """Run passes (default: all) over the repo sources."""
    if passes is None:
        passes = all_passes()
    return run_passes(passes, repo_context(root), PASS_IDS)


def check_modules(pass_obj: Pass, modules) -> list[Finding]:
    """Run one AST pass over live modules' sources, suppressions
    applied -- the hook tests use (e.g. tests/test_torch_frontend.py
    runs the clock-seam pass over the frontend + clock modules)."""
    files = []
    for mod in modules:
        src_path = inspect.getsourcefile(mod)
        text = Path(src_path).read_text()
        try:
            rel = Path(src_path).resolve().relative_to(
                repo_root()).as_posix()
        except ValueError:
            rel = Path(src_path).name
        files.append(SourceFile(path=rel, text=text))
    ctx = Context(files=files, root=repo_root())
    report = run_passes([pass_obj], ctx, PASS_IDS)
    return report.findings
