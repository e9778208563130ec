"""Dispatch passes: the static host-sync detector and the
frontier-sized HBM-intermediate budgets.

Port of ``repro/analysis/jaxpr_passes.py`` (the file keeps the
reference's name, as ``launch/hlo_walk.py`` does). The reference traces
each program to a jaxpr and reads its equations. The port's programs are
eager PyTorch: each runs once, under a dispatch mode that sees every
aten op it dispatches (:class:`SyncRecorder`) and under the op walk
(``launch/hlo_walk.py``).

``jit-boundary`` runs every program of ``programs.build_specs`` and
flags (a) each host sync inside it -- what a host callback at a jit
boundary is to the reference: the host waits for the device once a
call -- and (b) any dimension outside its declared bucket class. A host
sync is

  * ``_local_scalar_dense``: a read of one value (``.item()``,
    ``int(t)``, ``bool(t)``), and ``equal``, which returns a host bool;
  * a copy between the host and a device made without ``non_blocking``
    (``_to_copy``, ``copy_``), and a tensor made on a device from host
    data (``lift_fresh`` on a device: ``torch.as_tensor(a, device=)``);
  * an op whose output shape depends on the data: ``nonzero``,
    ``masked_select``, ``unique*``, ``bincount``, ``repeat_interleave``
    without ``output_size``, and indexing by a boolean mask (``index``,
    ``index_put``).

On fake tensors nothing is read: a fake branch that skips a read the
real branch makes declares it (``kernels/cost.host_read``); ``nonzero``
and ``masked_select`` are taken at their largest output (every element
selected), so that the program runs on; and any other op that raises
``DataDependentOutputException`` or ``DynamicOutputShapeException`` is
a sync of that op (and the program a ``:trace`` finding).

``hbm-budget`` counts the frontier-sized (>= B*n/2 element) arrays each
backend's single-source and top-k programs write, by the op walk's
records (a kernel's result and its scratch included, and a library
sort's own scratch), and gates them against a per-program budget at
``HBM_GEOMETRY``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import programs
from repro_torch.analysis.core import Context, Finding, Pass
from repro_torch.kernels import cost as _cost

# ops whose output shape depends on the data
DATA_DEPENDENT = ("nonzero", "masked_select", "unique", "_unique",
                  "_unique2", "unique_dim", "unique_consecutive",
                  "unique_dim_consecutive", "repeat_interleave",
                  "bincount")
# indexing ops, data-dependent where an index is a boolean mask
_MASK_INDEXED = ("index", "index_put", "index_put_", "_index_put_impl",
                 "_index_put_impl_")
# frames that are the analyzer's or the walk's, never a sync's site
_NOT_SITES = ("src/repro_torch/analysis/",
              "src/repro_torch/launch/hlo_walk.py",
              "src/repro_torch/kernels/cost.py")


@dataclasses.dataclass(frozen=True)
class Sync:
    """One host sync: the aten op, and where the program made it (the
    innermost frame of the repo, repo-relative, and the chain of the
    repo's frames, innermost first)."""
    op: str
    file: str
    line: int
    where: tuple = ()


def _site() -> tuple[str, int, tuple]:
    root = Path(__file__).resolve().parents[3]
    chain = []
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith("<"):
            continue
        try:
            rel = Path(fr.filename).resolve().relative_to(root).as_posix()
        except ValueError:
            continue
        if rel.startswith(_NOT_SITES):
            continue
        chain.append(f"{rel}:{fr.lineno} ({fr.name})")
        if len(chain) == 1:
            file, line = rel, fr.lineno
    if not chain:
        return "", 0, ()
    return file, line, tuple(chain[:4])


def _device_type(x) -> str:
    return torch.device(x).type if x is not None else "cpu"


def sync_op(func, args, kwargs) -> str | None:
    """The host sync that the aten op ``func`` makes on these arguments,
    or None (the module docstring's list)."""
    name = func.__name__.split(".")[0]
    if name in ("_local_scalar_dense", "equal"):
        return name
    if name in DATA_DEPENDENT:
        if name == "repeat_interleave" and \
                kwargs.get("output_size") is not None:
            return None
        return name
    if name in _MASK_INDEXED:
        idx = args[1] if len(args) > 1 else ()
        if any(t is not None and t.dtype in (torch.bool, torch.uint8)
               for t in idx):
            return "index_put" if "put" in name else "index"
        return None
    if name == "_to_copy":
        dst = kwargs.get("device")
        if dst is None or kwargs.get("non_blocking", False):
            return None
        src = args[0].device.type
        return name if (src == "cpu") != (_device_type(dst) == "cpu") \
            else None
    if name == "copy_":
        nb = args[2] if len(args) > 2 else kwargs.get("non_blocking", False)
        a, b = args[0].device.type, args[1].device.type
        return name if not nb and (a == "cpu") != (b == "cpu") else None
    if name == "lift_fresh":
        return name if args[0].device.type != "cpu" else None
    return None


def _worst_output(name: str, args):
    """``nonzero`` / ``masked_select`` on fakes at their largest output,
    None for any other op."""
    from torch._subclasses.fake_tensor import FakeTensor
    x = args[0]
    if not isinstance(x, FakeTensor):
        return None
    if name == "nonzero":
        _cost.worst_case("nonzero: every element taken as nonzero")
        return torch.empty((x.numel(), x.dim()), dtype=torch.int64,
                           device=x.device)
    if name == "masked_select":
        _cost.worst_case("masked_select: every element taken as selected")
        numel = torch.broadcast_shapes(x.shape, args[1].shape).numel()
        return torch.empty((numel,), dtype=x.dtype, device=x.device)
    return None


class SyncRecorder(TorchDispatchMode):
    """Records every host sync of the aten ops dispatched inside it (and
    the reads that fake branches declare, through :meth:`note` as a
    ``kernels/cost.listen_syncs`` listener: :func:`record_syncs` wires
    both)."""

    def __init__(self):
        super().__init__()
        self.syncs: list[Sync] = []

    def note(self, op: str) -> None:
        self.syncs.append(Sync(op, *_site()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException, DynamicOutputShapeException)
        kwargs = kwargs or {}
        op = sync_op(func, args, kwargs)
        if op is not None:
            self.note(op)
            worst = _worst_output(op, args)
            if worst is not None:
                return worst
        try:
            return func(*args, **kwargs)
        except (DataDependentOutputException, DynamicOutputShapeException):
            if op is None:
                self.note(func.__name__.split(".")[0])
            raise


@contextlib.contextmanager
def record_syncs(args=()):
    """A :class:`SyncRecorder` over the block, with the fake mode of
    ``args`` (if any) entered beneath it so that fake ops reach the
    recorder first, and the declared host reads told to it."""
    from torch._guards import active_fake_mode
    from repro_torch.launch.hlo_walk import _fake_mode
    rec = SyncRecorder()
    mode = _fake_mode(args)
    with contextlib.ExitStack() as stack:
        if mode is not None and active_fake_mode() is not mode:
            stack.enter_context(mode)
        stack.enter_context(rec)
        stack.enter_context(_cost.listen_syncs(rec.note))
        yield rec


def run_program(fn, args, walk: bool = True):
    """Call ``fn(*args)`` once under a :class:`SyncRecorder` and, with
    ``walk``, the op walk: (the walk's totals or None, the syncs)."""
    from repro_torch.launch import hlo_walk
    with record_syncs(args) as rec:
        if walk:
            totals = hlo_walk.analyze(fn, *args)
        else:
            fn(*args)
            totals = None
    return totals, rec.syncs


def frontier_writes(records, min_elems: int) -> int:
    """The arrays of at least ``min_elems`` elements that the op walk's
    ``records`` write: one for each such output of each op (a kernel's
    result and scratch each counted) and each such scratch array a
    library op allocates (``hlo_walk.library_scratch``)."""
    return sum(1 for r in records for e in r.outs + r.scratch
               if e >= min_elems)


def count_hbm_intermediates(fn, *args, min_elems: int) -> int:
    """Number of frontier-sized (>= ``min_elems`` element) arrays that
    one call of ``fn(*args)`` writes, by the op walk -- each a
    frontier-sized HBM materialization. The op-count form of the
    kernel-fusion acceptance gate, measurable without a card (fake
    arguments run a kernel's wrapper as its recorded cost)."""
    totals, _ = run_program(fn, args)
    return frontier_writes(totals.records, min_elems)


# ----------------------------------------------------------------------
# jit-boundary pass
# ----------------------------------------------------------------------
class JitBoundaryPass(Pass):
    """No host syncs / non-bucketed shapes inside any program call."""

    pass_id = "jit-boundary"

    def run(self, ctx: Context) -> list[Finding]:
        uni = programs.universe()
        findings: list[Finding] = []
        self.skipped: list[str] = []
        for spec in programs.build_specs():
            findings.extend(self.check_spec(spec, uni))
        return findings

    def check_spec(self, spec: programs.ProgramSpec,
                   uni: dict | None = None, devices=None) -> list[Finding]:
        if uni is None:
            uni = programs.universe()
        findings: list[Finding] = []
        rec_syncs: list[Sync] = []
        try:
            fn, args = spec.make() if devices is None \
                else spec.make(devices)
            with record_syncs(args) as rec:
                try:
                    fn(*args)
                finally:
                    rec_syncs = rec.syncs
        except Exception as e:  # a program that no longer runs is
            findings.append(Finding(  # itself a contract break
                pass_id=self.pass_id, file=spec.file, line=1,
                key=f"{spec.name}:trace",
                message=f"program {spec.name} failed to run over its "
                        f"declared shapes: {type(e).__name__}: {e}"))
        for s in first_syncs(rec_syncs):
            findings.append(Finding(
                pass_id=self.pass_id, file=s.file or spec.file,
                line=s.line or 1, key=f"{spec.name}:sync:{s.op}",
                message=f"program {spec.name} syncs the host on "
                        f"'{s.op}' inside its call (the host waits for "
                        f"the device each call), first at "
                        f"{' <- '.join(s.where) or spec.file}"))
        geo_n = programs._geometry(uni)["n"]
        for d in spec.dims:
            if not programs.bucket_ok(d, geo_n, uni):
                findings.append(Finding(
                    pass_id=self.pass_id, file=spec.file, line=1,
                    key=f"{spec.name}:dim:{d.name}",
                    message=f"program {spec.name} dimension "
                            f"{d.name}={d.value} is outside its "
                            f"declared bucket class '{d.bucket}' -- "
                            "this shape grows the engine's dispatch "
                            "shape set per distinct value"))
        return findings


def first_syncs(syncs) -> list[Sync]:
    """The first sync of each op, in the order the ops first synced."""
    seen: dict[str, Sync] = {}
    for s in syncs:
        seen.setdefault(s.op, s)
    return list(seen.values())


# ----------------------------------------------------------------------
# HBM-intermediate budgets
# ----------------------------------------------------------------------
# Canonical gate geometry (the reference's; the plain rows run on the
# CPU at this size in a few seconds, the kernel rows on fakes).
HBM_GEOMETRY = {"n": 10_000, "deg": 3, "B": 16, "W": 64, "l_max": 10}

# Frontier-sized arrays written per (program, backend) at HBM_GEOMETRY,
# set from the port's first measurement with the op walk: the plain
# push writes 9 a level over its 11 levels (the prune's mask and select,
# the edge gather, the weighting, the segment sum, the seed buffer and
# its scatter, the add and the copy into the ping-pong buffer), plus the
# zero frontier and the transposed result; the kernel writes its (B, n)
# result and its 4nB-word scratch; top-k adds the sort's values and ids
# and the four scratch arrays of its radix sort. A regression above
# budget is a finding, an improvement is a prompt to ratchet the budget
# down.
HBM_BUDGETS = {
    ("source", "plain"): 101,
    ("source", "kernel"): 2,
    ("topk", "plain"): 107,
    ("topk", "kernel"): 8,
}


@dataclasses.dataclass(frozen=True)
class BudgetRow:
    program: str
    backend: str
    measured: int
    budget: int | None
    min_elems: int
    model_bytes: int      # the op walk's HBM bytes of the call

    @property
    def over(self) -> bool:
        return self.budget is not None and self.measured > self.budget


def hbm_budget_report(n: int | None = None) -> list[BudgetRow]:
    """Count frontier-sized arrays written by each gated program.

    Budgets apply at the canonical ``HBM_GEOMETRY`` n; at any other n
    the rows carry ``budget=None`` (measured only -- callers can still
    assert kernel <= plain). The plain rows run on the CPU, the kernel
    rows on fakes.
    """
    geo = dict(HBM_GEOMETRY)
    if n is not None:
        geo["n"] = n
    n, deg, B, W, l_max = (geo["n"], geo["deg"], geo["B"], geo["W"],
                           geo["l_max"])
    canonical = n == HBM_GEOMETRY["n"]
    min_elems = B * n // 2       # anything frontier-sized
    rows = []
    for prog, k in (("source", None), ("topk", 16)):
        for backend in ("plain", "kernel"):
            fn, args = programs.push_program(n, deg, W, l_max, B, backend, k)
            totals, _ = run_program(fn, args)
            rows.append(BudgetRow(
                program=prog, backend=backend,
                measured=frontier_writes(totals.records, min_elems),
                budget=HBM_BUDGETS[(prog, backend)] if canonical else None,
                min_elems=min_elems, model_bytes=int(totals.hbm_bytes)))
    return rows


class HbmBudgetPass(Pass):
    """Per-program frontier-sized HBM-intermediate budgets."""

    pass_id = "hbm-budget"

    def run(self, ctx: Context) -> list[Finding]:
        findings: list[Finding] = []
        for row in hbm_budget_report():
            if row.over:
                findings.append(Finding(
                    pass_id=self.pass_id,
                    file="src/repro_torch/core/single_source.py"
                    if row.program == "source"
                    else "src/repro_torch/core/topk.py",
                    line=1,
                    key=f"{row.program}/{row.backend}:hbm",
                    message=f"{row.program}/{row.backend} writes "
                            f"{row.measured} frontier-sized HBM "
                            f"arrays at n={HBM_GEOMETRY['n']} (budget "
                            f"{row.budget}); fusion regressed"))
        return findings
