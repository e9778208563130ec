"""The port's static analyzer (repro_torch.analysis) held against the
reference's (repro.analysis) on the CPU.

* The AST passes give the same (pass, file, line, key) in both packages,
  on the reference's fixtures and over the whole port tree; deleting a
  ``with self._lock:`` from the port's frontend is caught statically.
* The framework: suppressions, baselines (byte-equal files, loaded
  across the packages), the CLI's exit codes and ``--update-baseline``.
* The registry maps onto the reference's (lax -> plain, pallas ->
  kernel), with each difference named; ``universe``, ``bucket_ok`` and
  ``contract_model_bytes`` agree.
* The dispatch passes: a ``.item()`` inside a program and a dimension
  outside its bucket are findings (the port's counterpart of the
  reference's standing callback failure); the HBM rows hold their
  budgets; a toy count equals a hand count.
* The collective pass: the four sharded programs move only the contract's
  kinds, within SLACK of its model, with the reference's kind set from
  its compiled HLO (one subprocess at two forced host devices); an
  unnamed copy is flagged. Naming the copies changes no answer.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import analysis as ranalysis
from repro.analysis import ast_passes as rast
from repro.analysis import core as rcore
from repro.analysis import hlo_passes as rhlo
from repro.analysis import programs as rprograms
from repro_torch import analysis as tanalysis
from repro_torch.analysis import ast_passes as tast
from repro_torch.analysis import core as tcore
from repro_torch.analysis import hlo_passes as thlo
from repro_torch.analysis import jaxpr_passes as tjp
from repro_torch.analysis import programs as tprograms

pytestmark = pytest.mark.lint

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "analysis_fixtures"
AST_PASSES = ("LockDisciplinePass", "ClockSeamPass", "BannedApiPass")
REF_KINDS = r"""
import json, jax
from repro.analysis import programs
from repro.launch import hlo_analysis
out = {}
for spec in programs.build_specs(jax.device_count()):
    if spec.devices < 2:
        continue
    fn, args = spec.make()
    txt = jax.jit(fn).lower(*args).compile().as_text()
    out[spec.name] = sorted(hlo_analysis.collective_stats(txt).count_by_op)
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def procs():
    """Two subprocesses, started with the module so that they run beside
    its other tests: the reference's collective kinds per sharded
    program, from its compiled HLO on two forced host devices, and the
    port's CLI with the shipped baseline."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = {
        "ref_kinds": subprocess.Popen(
            [sys.executable, "-c", REF_KINDS], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=dict(
                env, XLA_FLAGS="--xla_force_host_platform_device_count=2")),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis", "--baseline",
             "ANALYSIS_BASELINE_TORCH.json", "--json"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    yield out
    for proc in out.values():
        proc.kill()
        proc.communicate()


def _rows(findings) -> list:
    return sorted((f.pass_id, f.file, f.line, f.key) for f in findings)


def _contexts(files):
    """The same (path, text) pairs as a Context of each package."""
    return (rcore.Context(files=[rcore.SourceFile(path=p, text=t)
                                 for p, t in files], root=ROOT),
            tcore.Context(files=[tcore.SourceFile(path=p, text=t)
                                 for p, t in files], root=ROOT))


def _both(files, pass_name):
    rctx, tctx = _contexts(files)
    rrep = rcore.run_passes([getattr(rast, pass_name)()], rctx,
                            ranalysis.PASS_IDS)
    trep = tcore.run_passes([getattr(tast, pass_name)()], tctx,
                            tanalysis.PASS_IDS)
    return rrep, trep


# ----------------------------------------------------------------------
# the AST passes, rule for rule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pass_name", AST_PASSES)
@pytest.mark.parametrize("fixture", sorted(p.name for p in
                                           FIXTURES.glob("*.py")))
def test_ast_pass_matches_reference_on_fixture(fixture, pass_name):
    path = f"tests/analysis_fixtures/{fixture}"
    rrep, trep = _both([(path, (FIXTURES / fixture).read_text())],
                       pass_name)
    assert _rows(trep.findings) == _rows(rrep.findings)
    assert _rows(trep.suppressed) == _rows(rrep.suppressed)


@pytest.mark.parametrize("pass_name", AST_PASSES)
def test_ast_pass_matches_reference_over_port_tree(pass_name):
    """Over every module of src/repro_torch: the same findings and the
    same suppressions in both packages, and none left unsuppressed."""
    ctx = tanalysis.repo_context()
    assert len(ctx.files) > 100
    rrep, trep = _both([(sf.path, sf.text) for sf in ctx.files], pass_name)
    assert _rows(trep.findings) == _rows(rrep.findings) == []
    assert _rows(trep.suppressed) == _rows(rrep.suppressed)


def test_deleting_port_frontend_lock_is_caught_statically():
    path = "src/repro_torch/serve/frontend.py"
    text = (ROOT / path).read_text()
    checker = tast.LockDisciplinePass()
    assert checker.check_source(path, text) == []
    needle = "with self._lock:"
    n_locks = text.count(needle)
    assert n_locks >= 5
    caught: set = set()
    idx = -1
    for _ in range(n_locks):
        idx = text.index(needle, idx + 1)
        mutated = text[:idx] + "if True:" + text[idx + len(needle):]
        found = checker.check_source(path, mutated)
        assert _rows(found) == _rows(rast.LockDisciplinePass().check_source(
            path, mutated))
        caught |= {f.key.split(":")[0] for f in found}
    assert {"ServeFrontend._submit", "ServeFrontend._fail_unit",
            "ServeFrontend._run_unit", "ServeFrontend.swap_index",
            "ServeFrontend.close"} <= caught, caught


# ----------------------------------------------------------------------
# suppressions
# ----------------------------------------------------------------------
SUPPRESSION_CASES = {
    "unknown-id-refused": ("x = 1  # slinglint: disable=not-a-pass\n",
                           "ClockSeamPass", None),
    "per-pass-not-blanket": ("import time\ndef f():\n"
                             "    time.sleep(1)  "
                             "# slinglint: disable=banned-api\n",
                             "ClockSeamPass", (1, 0)),
    "applies-to-its-pass": ("import time\ndef f():\n"
                            "    time.sleep(1)  "
                            "# slinglint: disable=clock-seam\n",
                            "ClockSeamPass", (0, 1)),
    "subset-run-accepts-other-ids": ("import os\ndef f(a, b):\n"
                                     "    os.rename(a, b)  "
                                     "# slinglint: disable=banned-api\n",
                                     "ClockSeamPass", (0, 0)),
    "two-ids-one-line": ("import os, time\ndef f(a, b):\n"
                         "    os.rename(a, b); time.sleep(1)  "
                         "# slinglint: disable=banned-api,clock-seam\n",
                         "BannedApiPass", (0, 1)),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
def test_suppressions(case):
    """Each package on the same text: an unknown pass id in a disable
    comment is refused; a suppression applies to its own pass only."""
    text, pass_name, want = SUPPRESSION_CASES[case]
    if want is None:
        for ctx, core, ids, mod in zip(_contexts([("x.py", text)]),
                                       (rcore, tcore),
                                       (ranalysis.PASS_IDS,
                                        tanalysis.PASS_IDS), (rast, tast)):
            with pytest.raises(ValueError, match="not-a-pass"):
                core.run_passes([getattr(mod, pass_name)()], ctx, ids)
        return
    rrep, trep = _both([("x.py", text)], pass_name)
    for rep in (rrep, trep):
        assert (len(rep.findings), len(rep.suppressed)) == want
    assert _rows(trep.suppressed) == _rows(rrep.suppressed)


def test_pass_ids_are_the_references():
    assert tanalysis.PASS_IDS == ranalysis.PASS_IDS
    assert tuple(p.pass_id for p in tanalysis.all_passes()) == \
        tanalysis.PASS_IDS


# ----------------------------------------------------------------------
# baselines and the CLI
# ----------------------------------------------------------------------
def _findings(core):
    return [core.Finding(pass_id="jit-boundary",
                         file="src/repro_torch/core/walks.py", line=181,
                         key="walk/paired_meet:sync:nonzero", message="m"),
            core.Finding(pass_id="banned-api", file="src/x.py", line=3,
                         key="np.save:f", message="m2")]


def test_baselines_are_byte_equal_and_cross_load(tmp_path):
    rp, tp = tmp_path / "r.json", tmp_path / "t.json"
    rcore.save_baseline(rp, _findings(rcore))
    tcore.save_baseline(tp, _findings(tcore))
    assert rp.read_bytes() == tp.read_bytes()
    assert tcore.load_baseline(rp) == rcore.load_baseline(tp) == \
        {f.ident for f in _findings(tcore)}
    (tmp_path / "v.json").write_text('{"version": 99, "findings": []}')
    for core in (rcore, tcore):
        with pytest.raises(ValueError, match="version"):
            core.load_baseline(tmp_path / "v.json")
        assert core.load_baseline(tmp_path / "absent.json") == set()


def test_shipped_baseline_loads_in_both_packages():
    path = ROOT / "ANALYSIS_BASELINE_TORCH.json"
    got = tcore.load_baseline(path)
    assert got == rcore.load_baseline(path)
    assert got and {e[0] for e in got} <= {"jit-boundary"}


def test_update_baseline_idempotent(tmp_path):
    from repro_torch.analysis.__main__ import main
    p = tmp_path / "b.json"
    only = "lock-discipline,clock-seam,banned-api"
    assert main(["--only", only, "--baseline", str(p),
                 "--update-baseline"]) == 0
    first = p.read_bytes()
    assert main(["--only", only, "--baseline", str(p),
                 "--update-baseline"]) == 0
    assert p.read_bytes() == first


@pytest.mark.parametrize("case", ["clean", "baselined", "new",
                                  "bad-suppression"])
def test_cli_exit_codes(case, tmp_path, monkeypatch, capsys):
    """0 with no new finding, 1 on a new one, 2 on a bad suppression."""
    from repro_torch.analysis.__main__ import main
    text = {"clean": "x = 1\n",
            "baselined": "import time\ndef f():\n    time.sleep(1)\n",
            "new": "import time\ndef f():\n    time.sleep(1)\n",
            "bad-suppression": "x = 1  # slinglint: disable=nope\n"}[case]
    ctx = tcore.Context(files=[tcore.SourceFile(path="x.py", text=text)],
                        root=tmp_path)
    monkeypatch.setattr(tanalysis, "repo_context", lambda root=None: ctx)
    base = tmp_path / "b.json"
    if case == "baselined":
        assert main(["--only", "clock-seam", "--baseline", str(base),
                     "--update-baseline"]) == 0
    capsys.readouterr()
    rc = main(["--only", "clock-seam", "--baseline", str(base), "--json"])
    want = {"clean": 0, "baselined": 0, "new": 1, "bad-suppression": 2}
    assert rc == want[case]
    if case != "bad-suppression":
        rep = json.loads(capsys.readouterr().out)
        assert len(rep["new"]) == (case == "new")
        assert len(rep["findings"]) == (case != "clean")


def test_cli_passes_with_shipped_baseline(procs):
    """The whole analyzer over the port, as a user runs it: all six
    passes, none skipped, every finding baselined and named in ROADMAP's
    queue 2."""
    out, err = procs["cli"].communicate(timeout=300)
    assert procs["cli"].returncode == 0, err[-2000:]
    rep = json.loads(out)
    assert rep["new"] == [] and rep["skipped"] == {}
    assert {f["pass"] for f in rep["findings"]} == {"jit-boundary"}
    shipped = tcore.load_baseline(ROOT / "ANALYSIS_BASELINE_TORCH.json")
    assert {(f["pass"], f["file"], f["key"])
            for f in rep["findings"]} == shipped
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for f in rep["findings"]:
        assert f["key"] in roadmap, f["key"]


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------
# the reference's dims the port leaves out, each with its reason
DROPPED_DIMS = {
    ("source/lax", "edges"): "the port's push reads an exact CSR",
    ("source/pallas", "edge_pad"): "no Pallas blocked layout (eb-multiple)",
    ("topk/pallas/k=16", "edge_pad"): "no Pallas blocked layout",
    ("walk/paired_meet", "chunk"): "no walk-chunk bucket",
    ("prsim/pr_step", "edge_cap"): "the port's PageRank pads no edges",
    ("sharded-source/lax", "edge_cap"): "a slab's CSR takes its exact size",
    ("sharded-topk/lax", "edge_cap"): "a slab's CSR takes its exact size",
    ("sharded-source/pallas", "pblk_cap"): "no Pallas blocked layout",
    ("sharded-topk/pallas", "pblk_cap"): "no Pallas blocked layout",
}
# programs the port adds: the engine's pair kernel, which the
# reference's registry leaves out
ADDED = {"pair/kernel"}


def _port_name(ref_name: str) -> str:
    return ref_name.replace("/lax", "/plain").replace("/pallas", "/kernel")


def test_registry_maps_onto_the_references():
    ref = {s.name: s for s in rprograms.build_specs(2)}
    port = {s.name: s for s in tprograms.build_specs()}
    assert {_port_name(n) for n in ref} | ADDED == set(port)
    dropped = set()
    for name, rs in ref.items():
        ps = port[_port_name(name)]
        assert ps.devices == rs.devices
        pd = {d.name: d for d in ps.dims}
        for d in rs.dims:
            if (name, d.name) in DROPPED_DIMS:
                dropped.add((name, d.name))
                assert d.name not in pd
            else:
                assert pd.pop(d.name) == tprograms.Dim(d.name, d.value,
                                                       d.bucket)
        assert not pd, (name, pd)
    assert dropped == set(DROPPED_DIMS)
    assert {d.bucket for rs in ref.values() for d in rs.dims
            if (rs.name, d.name) in DROPPED_DIMS} >= \
        set(tprograms.LEFT_OUT_BUCKETS)
    assert [d for d in port["pair/kernel"].dims] == \
        list(port["pair/plain"].dims)


def test_universe_agrees_on_shared_keys():
    r, t = rprograms.universe(), tprograms.universe()
    shared = set(r) & set(t)
    assert shared == set(t)
    assert {k: r[k] for k in shared} == t
    assert set(r) - set(t) == {"walk_chunk", "eb", "bn"}


BUCKET_GRID = [(bucket, v, n) for bucket in ("cap-bucket", "k-bucket",
                                             "engine-pair-batch",
                                             "engine-source-batch",
                                             "join-tile")
               for v in (0, 1, 7, 8, 16, 63, 64, 100, 128, 256, 300)
               for n in (100, 256, 1000)]


def test_bucket_ok_agrees_with_reference():
    ru, tu = rprograms.universe(), tprograms.universe()
    for bucket, v, n in BUCKET_GRID:
        assert tprograms.bucket_ok(tprograms.Dim("x", v, bucket), n, tu) \
            == rprograms.bucket_ok(rprograms.Dim("x", v, bucket), n, ru), \
            (bucket, v, n)
    for bucket in tprograms.LEFT_OUT_BUCKETS:
        with pytest.raises(ValueError, match="by design"):
            tprograms.bucket_ok(tprograms.Dim("x", 64, bucket), 256, tu)


def test_contract_model_bytes_equal_reference():
    for kind in ("source", "topk"):
        for B, W, n, S, l_max, k in ((8, 64, 256, 2, 10, 16),
                                     (16, 32, 1000, 4, 7, 10),
                                     (1, 8, 5, 5, 1, 16)):
            kw = dict(B=B, W=W, n=n, S=S, l_max=l_max, k=k)
            assert thlo.contract_model_bytes(kind, **kw) == \
                rhlo.contract_model_bytes(kind, **kw)
    assert (thlo.ALLOWED_KINDS, thlo.SLACK) == (rhlo.ALLOWED_KINDS,
                                                rhlo.SLACK)


# ----------------------------------------------------------------------
# the dispatch passes
# ----------------------------------------------------------------------
def _spec(name, fn, args, dims=()):
    return tprograms.ProgramSpec(name=name, file="tests/x.py",
                                 make=lambda: (fn, args), dims=dims)


@pytest.mark.parametrize("where", ["cpu", "fake"])
def test_item_inside_a_program_is_a_sync(where):
    """The counterpart of the reference's host-callback test: a program
    that reads a value to the host is flagged, on real tensors and on
    fakes (where the read raises and the program is also a :trace)."""
    def fn(x):
        return x * int(x.sum())
    x = torch.ones(4)
    if where == "fake":
        x = tprograms.fake_args((x,))[0]
    found = tjp.JitBoundaryPass().check_spec(_spec("fixture/item", fn, (x,)))
    keys = {f.key for f in found}
    assert "fixture/item:sync:_local_scalar_dense" in keys
    assert ("fixture/item:trace" in keys) == (where == "fake")
    site = [f for f in found if ":sync:" in f.key][0]
    assert site.file == "tests/test_torch_analysis.py"
    line = Path(__file__).read_text().splitlines()[site.line - 1]
    assert "int(x.sum())" in line


SYNC_PROGRAMS = {
    "nonzero": (lambda x: torch.nonzero(x > 0.5), {"nonzero"}),
    "item": (lambda x: x.sum().item(), {"_local_scalar_dense"}),
    "bool": (lambda x: bool((x > 2).any()), {"_local_scalar_dense"}),
    "equal": (lambda x: torch.equal(x, x), {"equal"}),
    "masked_select": (lambda x: torch.masked_select(x, x > 0.5),
                      {"masked_select"}),
    "bool-index": (lambda x: x[x > 0.5], {"index"}),
    "bool-index-put": (lambda x: x.clone().index_put_((x > 0.5,),
                                                      torch.tensor(0.0)),
                       {"index_put"}),
    "unique": (lambda x: torch.unique(x), {"_unique2"}),
    "bincount": (lambda x: torch.bincount((x * 4).long()), {"bincount"}),
    "repeat_interleave": (lambda x: torch.repeat_interleave(
        torch.tensor([1, 2])), {"repeat_interleave"}),
    "repeat_interleave-sized": (lambda x: torch.repeat_interleave(
        torch.tensor([1, 2]), output_size=3), set()),
    "cpu-to-cpu": (lambda x: x.cpu() + x.to("cpu", torch.float64), set()),
    "none": (lambda x: torch.sort((x * 2).cumsum(0))[1][:3], set()),
}


@pytest.mark.parametrize("case", sorted(SYNC_PROGRAMS))
def test_sync_kinds(case):
    """Each kind of host sync, on CPU tensors (a copy between two CPU
    tensors is none)."""
    fn, want = SYNC_PROGRAMS[case]
    _, syncs = tjp.run_program(fn, (torch.rand(6),), walk=False)
    assert {s.op for s in syncs} == want


def test_device_host_copies_are_syncs_on_fakes():
    """A blocking copy between a (fake) device and the host syncs;
    a non_blocking one does not; a fake branch's declared read does."""
    from repro_torch.kernels import cost
    x = tprograms.fake_args((torch.ones(3),))[0]

    def fn(x):
        a = x.to("cpu")
        b = x.to("cpu", non_blocking=True)
        cost.host_read("_local_scalar_dense")
        return a, b
    _, syncs = tjp.run_program(fn, (x,), walk=False)
    assert [s.op for s in syncs] == ["_to_copy", "_local_scalar_dense"]


def test_dim_outside_its_bucket_is_a_finding():
    spec = _spec("fixture/bad-dim", lambda x: x * 2, (torch.ones(7),),
                 (tprograms.Dim("edges", 7, "cap-bucket"),))
    found = tjp.JitBoundaryPass().check_spec(spec)
    assert [f.key for f in found] == ["fixture/bad-dim:dim:edges"]


def test_registry_programs_run_and_their_syncs():
    """Every registered program runs; the syncs each reports are the
    shipped baseline's (and the kernel programs report none)."""
    found = []
    for spec in tprograms.build_specs():
        found += tjp.JitBoundaryPass().check_spec(spec)
    assert not [f for f in found if f.key.endswith(":trace")]
    assert not [f for f in found if ":dim:" in f.key]
    shipped = tcore.load_baseline(ROOT / "ANALYSIS_BASELINE_TORCH.json")
    assert {f.ident for f in found} == \
        {e for e in shipped if e[0] == "jit-boundary"}
    for f in found:
        name = f.key.split(":")[0]
        if name.endswith(("/kernel", "kernel/k=16")) and \
                not name.startswith("sharded"):
            raise AssertionError(f.key)


def test_toy_hbm_count_equals_hand_count():
    """y = x + 1 (100 elements), z = y.sum() (1), w = torch.cat([y, y])
    (200), s = torch.sort(w) (200 values, 200 ids): 4 arrays of >= 100
    elements, 5 with the threshold at 1."""
    def fn(x):
        y = x + 1
        w = torch.cat([y, y])
        return y.sum(), torch.sort(w)
    x = torch.rand(100)
    assert tjp.count_hbm_intermediates(fn, x, min_elems=100) == 4
    assert tjp.count_hbm_intermediates(fn, x, min_elems=1) == 5
    from repro_torch.kernels.horner_push import ops
    assert ops.count_hbm_intermediates(fn, x, min_elems=100) == 4


def test_kernel_records_carry_their_largest_output():
    """On fakes a kernel's record is counted by what it writes: the (B,
    n) result and its scratch, the largest's shape on the record."""
    geo = tjp.HBM_GEOMETRY
    fn, args = tprograms.push_program(1000, geo["deg"], geo["W"],
                                      geo["l_max"], 4, "kernel")
    walk, _ = tjp.run_program(fn, args)
    (rec,) = [r for r in walk.records if r.op.startswith("kernel:")]
    from repro_torch.kernels.horner_push import workspace_numel
    assert rec.shape == (workspace_numel(1000, 4, geo["l_max"]),)
    assert sorted(rec.outs) == [4 * 1000, workspace_numel(1000, 4,
                                                          geo["l_max"])]
    assert walk.kernels == {"horner_push_rows": 1}


def test_hbm_budget_rows():
    rows = {(r.program, r.backend): r for r in tjp.hbm_budget_report()}
    assert set(rows) == set(tjp.HBM_BUDGETS)
    for key, r in rows.items():
        assert r.budget == tjp.HBM_BUDGETS[key] and not r.over
        assert r.min_elems == tjp.HBM_GEOMETRY["B"] * \
            tjp.HBM_GEOMETRY["n"] // 2
    for prog in ("source", "topk"):
        assert rows[(prog, "kernel")].measured <= \
            rows[(prog, "plain")].measured
    off = tjp.hbm_budget_report(n=2000)
    assert all(r.budget is None and not r.over for r in off)
    assert all(a.measured == b.measured for a, b in
               zip(off, tjp.hbm_budget_report(n=2000)))


# ----------------------------------------------------------------------
# the collective pass
# ----------------------------------------------------------------------
def test_sharded_programs_hold_the_contract(procs):
    uni = tprograms.universe()
    g = tprograms._geometry(uni)
    port = {}
    for spec in tprograms.build_specs():
        if spec.devices < 2:
            continue
        assert thlo.CollectiveContractPass().check_spec(spec) == []
        walk, _ = thlo.walk_spec(spec)
        kind = "topk" if "topk" in spec.name else "source"
        model = thlo.contract_model_bytes(kind, B=uni["source_batch"],
                                          W=g["W"], n=g["n"], S=2,
                                          l_max=g["l_max"])
        assert 0 < walk.coll_bytes <= thlo.SLACK * model
        port[spec.name] = sorted(walk.coll_by_op)
    out, err = procs["ref_kinds"].communicate(timeout=240)
    assert procs["ref_kinds"].returncode == 0, err[-2000:]
    ref = json.loads(out.strip().splitlines()[-1])
    assert {_port_name(k): v for k, v in ref.items()} == port
    assert all(v == ["all-gather", "all-reduce"] for v in port.values())


def test_unnamed_copy_is_flagged():
    base = {s.name: s for s in tprograms.build_specs()}[
        "sharded-source/kernel"]

    def make(devices=None):
        fn, args = base.make(devices)

        def leaky(us):
            outs = fn(us)
            return outs + [outs[1].to(outs[0].device)]   # names no kind
        return leaky, args
    spec = dataclasses.replace(base, name="fixture/leaky", make=make)
    keys = [f.key for f in thlo.CollectiveContractPass().check_spec(spec)]
    assert keys == ["fixture/leaky:kind:copy"]


def _zoo_answers(name, named: bool, monkeypatch):
    """A 2-shard index of a zoo graph whose slabs report two devices (the
    multi-device route on CPU tensors): per-shard scores and the top-k
    merge, with the copies named or with the names made no-ops."""
    from repro_torch.core import build as tbuild
    from repro_torch.core import shard_query as tsq
    from repro_torch.core import single_source as tss
    from repro_torch.kernels.horner_push import Slab

    import oracle

    @dataclasses.dataclass(frozen=True)
    class Placed(Slab):
        where: torch.device = torch.device("cpu")

        @property
        def device(self):
            return self.where

    if not named:
        for mod in (tss, tsq):
            monkeypatch.setattr(mod, "collective",
                                lambda kind: contextlib.nullcontext())
    from repro_torch import convert
    g = oracle.cases()[name]
    tg = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    idx = tbuild.build_index(tg, eps=0.1, exact_d=True, seed=0, device="cpu")
    si = tsq.shard_index(idx, tg, tsq.serving_mesh(2, devices=["cpu"] * 2))
    si.slabs = [Placed(**{f.name: getattr(sl, f.name)
                          for f in dataclasses.fields(Slab)},
                       where=torch.device("cpu", s))
                for s, sl in enumerate(si.slabs)]
    assert not si.one_device
    us = [0, 3, min(17, g.n - 1)]
    outs = tsq.sharded_scores(si, us)
    v, i = tsq._merge_topk(outs, si.n, si.n_loc, 5, si.devices[0])
    return torch.cat(outs), v, i


@pytest.mark.parametrize("name", ["er", "powerlaw", "dag", "sinks",
                                  "multigraph"])
def test_naming_copies_changes_no_answer(name, monkeypatch):
    """The sharded answers on the oracle zoo are equal bit for bit with
    the copies named and with the names made no-ops."""
    named = _zoo_answers(name, True, monkeypatch)
    monkeypatch.undo()
    bare = _zoo_answers(name, False, monkeypatch)
    for a, b in zip(named, bare):
        assert torch.equal(a, b)
