"""The examples of the PyTorch port (the three SLING examples, the GCN
trained on SimRank anchor features and the small LM), run in this
process on the CPU at small sizes, checked by their printed lines; and
the rule that they import neither jax nor the reference package."""
import ast
import importlib.util
import re
from pathlib import Path

import pytest

from repro_torch.graph import generators

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("torch_quickstart", "torch_dynamic_graph", "torch_sling_serve",
         "torch_train_gnn_simrank", "torch_train_lm_small")


def _run(name, argv, capsys):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
            for a in node.names]
    mods += [node.module for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]
    assert any(m.startswith("repro_torch") for m in mods)


def test_quickstart_ends_within_eps(capsys):
    out = _run("torch_quickstart", ["--device", "cpu", "--n", "120"], capsys)
    m = generators.barabasi_albert(120, 3, seed=0, directed=False).m
    assert out[0] == f"graph: n=120, m={m}"
    assert sum(line.startswith("  s(") for line in out) == 5
    m = re.fullmatch(r"max error vs power method: ([0-9.]+) \(bound "
                     r"eps=0.1\) -> OK", out[-1])
    assert m and float(m.group(1)) <= 0.1


def test_dynamic_graph_swaps_and_rebuilds(capsys):
    out = _run("torch_dynamic_graph",
               ["--device", "cpu", "--n", "200", "--batches", "2"], capsys)
    assert out[0].startswith("graph: n=200 ")
    assert [line[:9] for line in out if line.startswith("[batch")] == \
        ["[batch 0]", "[batch 1]"]
    assert all("(0 recompiles," in line for line in out
               if line.startswith("[batch"))
    m = re.fullmatch(r"engine: (\d+) swaps, 0 bucket overflows, epoch \d+, "
                     r"last swap [0-9.]+ms", out[-1])
    assert m and int(m.group(1)) >= 2


def test_sling_serve_prints_latencies_and_audit(capsys):
    out = _run("torch_sling_serve",
               ["--device", "cpu", "--n", "300", "--pair-batches", "3",
                "--source-batches", "2"], capsys)
    m = generators.barabasi_albert(300, 4, seed=0, directed=False).m
    assert out[0] == f"[serve] graph n=300 m={m}"
    assert re.fullmatch(r"\[serve\] 768 pair queries: p50 [0-9.]+ us/query, "
                        r"p99 batch [0-9.]+ ms", out[-3])
    assert re.fullmatch(r"\[serve\] 16 single-source queries: p50 [0-9.]+ "
                        r"ms/query", out[-2])
    m = re.fullmatch(r"\[serve\] audit max err ([0-9.]+) <= eps=0.15",
                     out[-1])
    assert m and float(m.group(1)) <= 0.15


def test_train_gnn_simrank_loss_falls(capsys):
    out = _run("torch_train_gnn_simrank",
               ["--device", "cpu", "--n", "200", "--steps", "60"], capsys)
    m = generators.barabasi_albert(200, 4, seed=0, directed=False).m
    assert out[0] == f"graph n=200 m={m}"
    assert out[1].startswith("SimRank anchor features via bulk join: "
                             "(200, 8), ")
    assert [line.split()[2] for line in out if line.startswith(
        "[trainer]")] == ["0", "50", "59"]
    got = re.fullmatch(r"final train accuracy: ([0-9.]+) \(loss ([0-9.]+) "
                       r"-> ([0-9.]+)\)", out[-1])
    assert got and float(got.group(3)) < float(got.group(2))


def test_train_lm_small_loss_falls(capsys):
    out = _run("torch_train_lm_small", ["--device", "cpu", "--steps", "40"],
               capsys)
    assert re.fullmatch(r"model: smollm-smoke, \d+K params", out[0])
    assert [line.split()[2] for line in out if line.startswith(
        "[trainer]")] == ["0", "39"]
    got = re.fullmatch(r"loss ([0-9.]+) -> ([0-9.]+)", out[-1])
    assert got and float(got.group(2)) < float(got.group(1))
