"""Foundation of the PyTorch port held against the JAX reference:
CSR arrays, generators, pull weights, the Theorem-1 plan, the power
method, and the rule that the port imports neither jax nor repro."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle
from repro.baselines import power as rpower
from repro.core import diagonal as rdiagonal
from repro.core import theory as rtheory
from repro.graph import csr as rcsr
from repro.graph import generators as rgen
from repro_torch import convert
from repro_torch.baselines import power as tpower
from repro_torch.core import diagonal as tdiagonal
from repro_torch.core import theory as ttheory
from repro_torch.device import resolve_device
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
CSR_FIELDS = ("n", "m", "in_ptr", "in_idx", "out_ptr", "out_idx",
              "edge_dst", "edge_src")


def _port_cases():
    """tests/oracle.py's zoo, built with the port's generators."""
    return {
        "er": tgen.erdos_renyi(48, 150, seed=3, directed=True),
        "powerlaw": tgen.barabasi_albert(64, 3, seed=1, directed=False),
        "dag": tgen.dag(40, 110, seed=5),
        "sinks": tgen.with_sinks(40, 120, n_sinks=5, seed=7),
        "multigraph": tgen.multigraph(32, 90, seed=9),
        "ba2000": tgen.barabasi_albert(2000, 4, seed=0),
    }


def _ref_cases():
    return {**oracle.cases(), "ba2000": rgen.barabasi_albert(2000, 4, seed=0)}


CASES = tuple(_ref_cases())


def _assert_same_graph(a, b):
    for f in CSR_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, int):
            assert x == y, f
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", CASES)
def test_generators_and_csr_equal_reference(name):
    _assert_same_graph(_port_cases()[name], _ref_cases()[name])


@pytest.mark.parametrize("name", CASES)
def test_pull_weights_equal_reference(name):
    t, r = _port_cases()[name], _ref_cases()[name]
    for c in (0.4, 0.6, 0.8):
        np.testing.assert_array_equal(
            tcsr.normalized_pull_weights(t, c ** 0.5),
            rcsr.normalized_pull_weights(r, c ** 0.5))


@pytest.mark.parametrize("name", CASES)
def test_graph_from_arrays_carries_reference_graph(name):
    r = _ref_cases()[name]
    g = convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)
    for f in ("n", "m", "in_ptr", "in_idx", "edge_dst", "edge_src"):
        x, y = getattr(g, f), getattr(r, f)
        assert np.array_equal(x, y), f


def test_paper_scale_table_matches_reference():
    g = tgen.paper_scale("GrQc", seed=0)
    _assert_same_graph(g, rgen.paper_scale("GrQc", seed=0))


@pytest.mark.parametrize("c", [0.4, 0.6, 0.8])
@pytest.mark.parametrize("eps", [0.025, 0.1])
def test_plan_fields_equal_reference(c, eps):
    for n in (32, 64, 36_692):
        t = ttheory.plan(eps=eps, c=c, n=n)
        r = rtheory.plan(eps=eps, c=c, n=n)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert t.error_bound() == r.error_bound() <= eps
        assert t.hp_entry_bound() == r.hp_entry_bound()
        assert ttheory.alg1_pairs(t.eps_d, t.delta_d, c) == \
            rtheory.alg1_pairs(r.eps_d, r.delta_d, c)
        mu = np.linspace(0.0, 0.5, 11)
        np.testing.assert_array_equal(
            ttheory.phase2_pairs_vec(mu, t.eps_d, t.delta_d, c),
            rtheory.phase2_pairs_vec(mu, r.eps_d, r.delta_d, c))


def test_paper_plan_numbers():
    """Section 7.1 settings at the Enron regime's n."""
    p = ttheory.plan(eps=0.025, c=0.6, n=36_692)
    assert p.l_max == 29 and p.t_max == 37
    assert p.theta == pytest.approx(7.27e-4, rel=1e-3)
    assert p.n_r1 == 12_668


@pytest.mark.parametrize("name", ["er", "multigraph", "sinks"])
def test_power_method_and_exact_diagonal_equal_reference(name):
    t, r = _port_cases()[name], _ref_cases()[name]
    np.testing.assert_array_equal(tpower.all_pairs(t, c=0.6, iters=30),
                                  rpower.all_pairs(r, c=0.6, iters=30))
    np.testing.assert_array_equal(tdiagonal.exact_diagonal(t, 0.6),
                                  rdiagonal.exact_diagonal(r, 0.6))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent.parent
                                          / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(f), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_port_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.serve, repro_torch.convert\n"
            "import repro_torch.launch.serve, repro_torch.core.build\n"
            "import repro_torch.core.update, repro_torch.kernels.spmv_ell\n"
            "import repro_torch.models.recsys, repro_torch.kernels.cin\n"
            "import repro_torch.core.device_state, repro_torch.train.steps\n"
            "import repro_torch.data.pipeline, repro_torch.configs.xdeepfm\n"
            "import repro_torch.launch.specs, repro_torch.join\n"
            "import repro_torch.serve.frontend, repro_torch.serve.clock\n"
            "import repro_torch.serve.load, repro_torch.analysis\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--only', 'lock-discipline,clock-seam,banned-api'])\n"
            "print('ok' if rc == 0 else f'rc {rc}')\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=PORT.parent.parent)
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0 and lines[-1] == "ok", (out.stdout,
                                                       out.stderr)
    assert lines[-2].startswith("slinglint: 0 finding(s), 0 new"), lines


def test_serve_cli_frontend_with_churn_on_cpu():
    """The serving CLI's frontend path: two replicas, a deadline, Zipf
    traffic in every mode, then two churn batches through the swap
    barrier; no request shed, no shape or bucket growth."""
    env = dict(os.environ, PYTHONPATH=str(PORT.parent), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--n", "200", "--frontend", "2", "--mode", "mixed", "--queries",
         "16", "--deadline-ms", "5000", "--mutate", "2"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=PORT.parent.parent)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1].endswith("0 new after warmup (fixed shape set OK)")
    for mode in ("source", "pair", "topk"):
        assert any(ln.startswith(f"[frontend {mode}] 16 requests")
                   and "shed 0/16" in ln for ln in lines), mode
    assert sum(ln.startswith("[mutate ") for ln in lines) == 2
    assert any("(fixed-shape swap OK)" in ln for ln in lines)


def test_entry_points_refuse_missing_card(monkeypatch):
    """No silent CPU fallback: asking for cuda without a card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
