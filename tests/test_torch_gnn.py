"""The port's GNN stack held against the JAX reference on the CPU, at
``smoke()`` sizes on graphs of at most 80 nodes: the four kinds'
forward passes (with and without SimRank features, on a batch with
padded edges and an isolated node), the loss and every leaf's gradient,
three train steps against the reference's jitted steps, the layers and
segment ops, ``gnn_batch``, the sampler (plain, ``knn=`` a file the
reference wrote, ``sim_index=``), the configs and shape tables,
checkpoints across the two packages, the training CLI, and that the new
modules import neither jax nor the reference package.

Parameters are the reference's ``init_params``, carried by
``convert.gnn_params_from_jax``. Tolerances: outputs within 1e-5 of max
|out|, gradients within 1e-5 of each leaf's max |g| (float32 reduction
order); parameters after train steps in units of lr, as
``tests/test_torch_train.py`` holds xDeepFM.

PNA's std aggregator has a NaN gradient in the reference wherever a
node's variance is 0 (``sqrt`` at 0), which the batches here hit; the
port gives those entries a zero gradient (``models/gnn.py``). So the
full PNA config's gradients are held where the reference's are finite,
the port's must be finite everywhere, and the std-free PNA config
(mean, max, min under the three scalers) is held on every leaf,
``segment_max`` ties on the multigraph included.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import base as rbase
from repro.core import build as rbuild
from repro.data import pipeline as rpipeline
from repro.graph import csr as rcsr
from repro.graph import generators as rgen
from repro.graph import sampler as rsampler
from repro.join import JoinConfig as RJoinConfig
from repro.join import KnnGraph as RKnnGraph
from repro.join import run_join as rrun_join
from repro.launch import specs as rspecs
from repro.models import gnn as RG
from repro.models import layers as RL
from repro.optim import adamw as radamw
from repro.train import checkpoint as rckpt
from repro.train import steps as rsteps
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipeline
from repro_torch.graph import sampler as tsampler
from repro_torch.join import KnnGraph as TKnnGraph
from repro_torch.launch import specs as tspecs
from repro_torch.models import gnn as TG
from repro_torch.models import layers as TL
from repro_torch.optim import adamw as tadamw
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import steps as tsteps

ARCHS = ("gcn-cora", "gat-cora", "pna", "graphcast")
TOL = 1e-5          # of max |out| or of a leaf's max |g|: float32 order
NO_STD = ("mean", "max", "min")
ROOT = Path(__file__).resolve().parents[1]


def _graph(name: str) -> rcsr.Graph:
    return {"ba": lambda: rgen.barabasi_albert(60, 2, seed=0,
                                               directed=False),
            "multigraph": lambda: rgen.multigraph(32, 90, seed=9)}[name]()


def _configs(arch: str, sim: int = 0, no_std: bool = False):
    r, t = rbase.get(arch).smoke(), tbase.get(arch).smoke()
    r = dataclasses.replace(r, sim_feats=sim)
    t = dataclasses.replace(t, sim_feats=sim)
    if no_std:
        r = dataclasses.replace(r, aggregators=NO_STD)
        t = dataclasses.replace(t, aggregators=NO_STD)
    return r, t


def _batch(cfg, g: rcsr.Graph, seed: int = 0, pads: int = 8) -> dict:
    """A batch over ``g`` plus one isolated node, ``pads`` padded edges
    (mask 0, src = dst = 0) and three masked nodes; graphcast's grid /
    mesh arrays as the CLI makes them."""
    rng = np.random.default_rng(seed)
    n = g.n + 1
    z = np.zeros(pads, np.int32)
    b = {"feats": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
         "edge_src": np.concatenate([g.edge_src, z]).astype(np.int32),
         "edge_dst": np.concatenate([g.edge_dst, z]).astype(np.int32),
         "edge_mask": np.concatenate([np.ones(g.m), z]).astype(np.float32),
         "node_mask": np.r_[np.ones(n - 3), np.zeros(3)].astype(np.float32),
         "labels": rng.integers(0, max(cfg.n_classes, 1), n).astype(
             np.int32)}
    if cfg.sim_feats:
        b["sim_feat"] = rng.uniform(size=(n, cfg.sim_feats)).astype(
            np.float32)
    if cfg.kind == "graphcast":
        h = n // 2
        b.update({"n_grid": np.int32(h),
                  "g2m_src": rng.integers(0, h, n).astype(np.int32),
                  "g2m_dst": rng.integers(h, n, n).astype(np.int32),
                  "g2m_mask": np.ones(n, np.float32),
                  "m2g_src": rng.integers(h, n, n).astype(np.int32),
                  "m2g_dst": rng.integers(0, h, n).astype(np.int32),
                  "m2g_mask": np.ones(n, np.float32),
                  "targets": rng.normal(size=(n, cfg.n_vars)).astype(
                      np.float32)})
    return b


def _params(rcfg, tcfg, seed: int = 0):
    params = RG.init_params(rcfg, jr.PRNGKey(seed))
    model = convert.gnn_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, model


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _names(tree) -> dict:
    names, leaves, _ = rckpt._flatten(tree)
    return {n: np.asarray(v) for n, v in zip(names, leaves)}


def _port_grads(tcfg, model, batch):
    from repro_torch.train.trainer import value_and_grad
    loss, grads = value_and_grad(lambda p, b: TG.loss_fn(tcfg, p, b),
                                 model, batch)
    return float(loss), {n: g.numpy() for n, g in grads.items()}


def _rel(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(float(np.abs(ref).max()), 1e-30))


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("sim", [0, 3], ids=["feats", "sim_feats"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch, sim):
    rcfg, tcfg = _configs(arch, sim)
    batch = _batch(rcfg, _graph("ba"))
    params, model = _params(rcfg, tcfg)
    ref = np.asarray(jax.jit(lambda p, b: RG.forward(rcfg, p, b))(
        params, _jnp(batch)))
    got = TG.forward(tcfg, model, batch)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL


def test_infer_step_is_forward_without_a_graph():
    rcfg, tcfg = _configs("gat-cora")
    batch = _batch(rcfg, _graph("multigraph"))
    _, model = _params(rcfg, tcfg)
    for p in model.parameters():
        p.requires_grad_(True)
    out = tsteps.gnn_infer_step(tcfg)(model, batch)
    assert out.is_inference() and out.grad_fn is None
    assert torch.equal(out, TG.forward(tcfg, model, batch).detach())


# ------------------------------------------------------ loss and grads


# the full PNA on the multigraph only: its reference runs eagerly (below)
GRAD_CASES = [(a, g) for a in ARCHS + ("pna-no-std",)
              for g in ("ba", "multigraph") if (a, g) != ("pna", "ba")]


@pytest.mark.parametrize("arch,graph", GRAD_CASES)
def test_loss_and_grads_equal_reference(arch, graph):
    no_std = arch == "pna-no-std"
    rcfg, tcfg = _configs("pna" if no_std else arch, no_std=no_std)
    batch = _batch(rcfg, _graph(graph))
    params, model = _params(rcfg, tcfg)
    vg = jax.value_and_grad(lambda p, b: RG.loss_fn(rcfg, p, b))
    # PNA's variance cancels to ~0 at some nodes, where sqrt magnifies
    # XLA's fused rounding: its eager reference rounds op by op, as the
    # port does
    r_loss, r_grads = (vg if arch == "pna" else jax.jit(vg))(
        params, _jnp(batch))
    t_loss, t_grads = _port_grads(tcfg, model, batch)
    assert abs(t_loss - float(r_loss)) <= TOL * abs(float(r_loss))
    ref = _names(r_grads)
    assert t_grads.keys() == ref.keys()
    held = 0
    for n, r in ref.items():
        assert np.isfinite(t_grads[n]).all(), n
        if arch == "pna" and not np.isfinite(r).all():
            continue      # the reference's std gradient (module docstring)
        assert _rel(t_grads[n], r) <= TOL, (n, _rel(t_grads[n], r))
        held += 1
    assert held >= (2 if arch == "pna" else len(ref))


def test_pna_std_gradient_is_the_reference_formula_where_defined():
    """d sqrt(max(var, 0)) / d var: the reference's value where var > 0,
    0 where var <= 0 (where the reference's is NaN or inf)."""
    var = np.array([-1e-3, 0.0, 1e-6, 0.25, 3.0], np.float32)
    ref = np.asarray(jax.vmap(jax.grad(
        lambda v: jnp.sqrt(jnp.maximum(v, 0.0))))(jnp.asarray(var)))
    t = torch.tensor(var, requires_grad=True)
    out = TG._pna_std(t)
    (g,) = torch.autograd.grad(out.sum(), t)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.sqrt(np.maximum(var, 0.0)))
    np.testing.assert_allclose(g.numpy()[2:], ref[2:], rtol=1e-6)
    assert (g.numpy()[:2] == 0).all() and not np.isfinite(ref[:2]).all()


def test_leaky_relu_gradient_at_zero_is_one():
    x = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    (g,) = torch.autograd.grad(TL.leaky_relu(x).sum(), x)
    ref = jax.vmap(jax.grad(RL.leaky_relu))(jnp.array([-2.0, 0.0, 3.0]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref))
    assert g[1] == 1.0


def test_segment_ops_equal_reference():
    """Out-of-range ids dropped (``compat.segment_sum`` counts an id in
    [-n, 0) from the end, ``segment_max`` drops it), an empty segment's
    max -inf, and the gradient of tied maxima split as the reference
    splits it."""
    rng = np.random.default_rng(2)
    ids = np.array([0, 2, 2, 2, -1, 5, 9, 0, -7], np.int32)
    data = rng.normal(size=(9, 3)).astype(np.float32)
    data[2] = data[1]                       # a tie in segment 2
    data[3] = data[1] - 1.0
    t_ids, t_data = torch.as_tensor(ids), torch.tensor(data)
    np.testing.assert_allclose(
        TL.segment_sum(t_data, t_ids, 6).numpy(),
        np.asarray(compat.segment_sum(jnp.asarray(data), ids, 6)),
        rtol=1e-6)
    r_max = np.asarray(jax.ops.segment_max(jnp.asarray(data), ids,
                                           num_segments=6))
    np.testing.assert_array_equal(TL.segment_max(t_data, t_ids, 6).numpy(),
                                  r_max)
    assert np.isneginf(r_max[1]).all()
    w = rng.normal(size=(6, 3)).astype(np.float32)
    w[1] = 0.0
    ref = np.asarray(jax.grad(lambda d: jnp.sum(jnp.where(
        jnp.isfinite(m := jax.ops.segment_max(d, ids, num_segments=6)),
        m, 0.0) * w))(jnp.asarray(data)))
    t_data.requires_grad_(True)
    m = TL.segment_max(t_data, t_ids, 6)
    (g,) = torch.autograd.grad(
        (torch.where(torch.isfinite(m), m, 0.0) * torch.tensor(w)).sum(),
        t_data)
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-6, atol=0)
    assert ref[1, 0] == ref[2, 0] == w[2, 0] / 2
    scores = rng.normal(size=(9, 2)).astype(np.float32)
    r_soft = jax.vmap(lambda col: RL.segment_softmax(col, ids, 6),
                      in_axes=1, out_axes=1)(jnp.asarray(scores))
    np.testing.assert_allclose(
        TL.segment_softmax(torch.tensor(scores), t_ids, 6).numpy(),
        np.asarray(r_soft), rtol=1e-6)


# ---------------------------------------------------------- train steps


def _diff_in_lr(got: dict, ref: dict, lr: float):
    """(worst |diff| / lr, entries over 1e-3 lr, total entries)."""
    worst, over, total = 0.0, 0, 0
    for n, r in ref.items():
        d = np.abs(np.asarray(got[n], np.float64) - r) / lr
        worst = max(worst, float(d.max()))
        over += int((d > 1e-3).sum())
        total += d.size
    return worst, over, total


@pytest.mark.parametrize("arch", ("gcn-cora", "gat-cora", "pna-no-std",
                                  "graphcast"))
def test_train_steps_equal_reference_jitted_steps(arch):
    """Three ``gnn_train_step`` calls against the reference's jitted step
    from the same parameters and batch: losses within 1e-5 relative,
    parameters within 1e-3 lr but at most 1 in 100 entries (these
    models are small), and within 2 lr a step there (AdamW's step is
    g / (|g| + eps): a near-zero gradient entry whose sign float32
    order flips moves by 2 lr). PNA runs std-free: the reference's full
    PNA step is NaN (module docstring)."""
    no_std = arch == "pna-no-std"
    rcfg, tcfg = _configs("pna" if no_std else arch, no_std=no_std)
    batch = _batch(rcfg, _graph("multigraph"))
    params, model = _params(rcfg, tcfg)
    lr = 1e-3
    r_opt, t_opt = radamw.AdamW(lr=lr), tadamw.AdamW(lr=lr)
    r_step = jax.jit(rsteps.gnn_train_step(rcfg, r_opt))
    t_step = tsteps.gnn_train_step(tcfg, t_opt)
    r_state, t_state = r_opt.init(params), t_opt.init(model)
    for k in range(3):
        params, r_state, r_m = r_step(params, r_state, _jnp(batch))
        model, t_state, t_m = t_step(model, t_state, batch)
        assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= \
            TOL * abs(float(r_m["loss"]))
        worst, over, total = _diff_in_lr(
            {n: p.detach().numpy() for n, p in tadamw.named_leaves(model)},
            _names(params), lr)
        assert over <= total // 100, (k, over, total)
        assert worst <= 2.0 * (k + 1) + 1e-3, (k, worst)
    assert int(t_state.step) == int(r_state.step) == 3


# ------------------------------------------------------ data, sampler


@pytest.mark.parametrize("sim", [False, True], ids=["plain", "sim_feat"])
def test_gnn_batch_equal_bits(sim):
    g = rgen.barabasi_albert(70, 3, seed=4, directed=False)
    t = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    sf = np.random.default_rng(1).uniform(size=(g.n, 5)) if sim else None
    r = rpipeline.gnn_batch(g, 9, 4, seed=3, sim_feat=sf)
    p = tpipeline.gnn_batch(t, 9, 4, seed=3, sim_feat=sf)
    assert r.keys() == p.keys()
    for k in r:
        assert r[k].dtype == p[k].dtype and np.array_equal(r[k], p[k]), k


@pytest.fixture(scope="module")
def sampler_inputs(tmp_path_factory):
    """An 80-node graph in both packages, the reference's exact-d index
    carried to the port, and a KnnGraph file the reference's join wrote."""
    g = rgen.barabasi_albert(80, 3, seed=5, directed=False)
    t = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    ri = rbuild.build_index(g, eps=0.1, exact_d=True)
    ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                   ri.hp.keys, ri.vals_f32(),
                                   ri.hp.counts, device="cpu")
    path = str(tmp_path_factory.mktemp("knn") / "knn.npz")
    rrun_join(ri, g, None, RJoinConfig(k=6, tile=16)).save(path)
    return g, t, ri, ti, path


@pytest.mark.parametrize("mode", ["plain", "knn", "sim_index"])
def test_sample_subgraph_equal_arrays(sampler_inputs, mode):
    g, t, ri, ti, path = sampler_inputs
    seeds = np.array([3, 17, 42, 60], np.int64)
    kw_r = {"plain": {}, "knn": {"knn": RKnnGraph.load(path)},
            "sim_index": {"sim_index": ri}}[mode]
    kw_t = {"plain": {}, "knn": {"knn": TKnnGraph.load(path)},
            "sim_index": {"sim_index": ti}}[mode]
    r = rsampler.sample_subgraph(g, seeds, (4, 3), np.random.default_rng(0),
                                 80, 64, **kw_r)
    p = tsampler.sample_subgraph(t, seeds, (4, 3), np.random.default_rng(0),
                                 80, 64, **kw_t)
    for f in dataclasses.fields(rsampler.SampledSubgraph):
        a, b = getattr(r, f.name), getattr(p, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert int(p.edge_mask.sum()) > len(seeds)
    with pytest.raises(ValueError):
        tsampler.sample_subgraph(t, seeds, (4, 3), np.random.default_rng(0),
                                 8, 64, **kw_t)


def test_knn_weights_equal_reference(sampler_inputs):
    g, t, _, _, path = sampler_inputs
    rk, tk = RKnnGraph.load(path), TKnnGraph.load(path)
    for v in range(g.n):
        nbrs = np.asarray(g.in_neighbors(v))
        np.testing.assert_array_equal(tsampler._knn_weights(tk, v, nbrs),
                                      rsampler._knn_weights(rk, v, nbrs))


# ------------------------------------------------------ configs, specs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    rs, ts = rbase.get(arch), tbase.get(arch)
    assert (rs.family, rs.shapes, rs.notes) == (ts.family, ts.shapes,
                                               ts.notes)
    for make in ("full", "smoke"):
        r = dataclasses.asdict(getattr(rs, make)())
        t = dataclasses.asdict(getattr(ts, make)())
        assert r.pop("dtype") == jnp.float32 and t.pop("dtype") == \
            torch.float32
        assert r == t
    for shape, d in rspecs.GNN_SHAPE_DEFS.items():
        cfg_r = dataclasses.replace(rs.full(), d_in=d["d_feat"])
        cfg_t = dataclasses.replace(ts.full(), d_in=d["d_feat"])
        assert tspecs.gnn_model_flops(cfg_t, d["n"], d["m"], d["d_feat"]) \
            == rspecs.gnn_model_flops(cfg_r, d["n"], d["m"], d["d_feat"])


def test_shape_tables_equal_reference():
    assert tbase.GNN_SHAPES == rbase.GNN_SHAPES
    assert tspecs.GNN_SHAPE_DEFS == rspecs.GNN_SHAPE_DEFS
    assert {a for a, s in tbase.all_archs().items() if s.family == "gnn"} \
        == set(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_the_reference_names_and_shapes(arch):
    rcfg, tcfg = _configs(arch)
    ref = _names(RG.init_params(rcfg, jr.PRNGKey(0)))
    own = TG.init_params(tcfg, torch.Generator().manual_seed(0))
    got = {n: tuple(p.shape) for n, p in tadamw.named_leaves(own)}
    assert got == {n: a.shape for n, a in ref.items()}
    assert not any(p.requires_grad for p in own.parameters())
    with pytest.raises(ValueError):
        convert.gnn_params_from_jax(tcfg, {"gnn": {}}, device="cpu")


# --------------------------------------------------------- checkpoints


def _trained_pair(arch):
    rcfg, tcfg = _configs(arch)
    batch = _batch(rcfg, _graph("ba"))
    params, model = _params(rcfg, tcfg)
    opt = radamw.AdamW(lr=1e-3)
    state = opt.init(params)
    params, state, _ = jax.jit(rsteps.gnn_train_step(rcfg, opt))(
        params, state, _jnp(batch))
    return rcfg, params, state, tcfg, model


@pytest.mark.parametrize("arch", ["gat-cora", "graphcast"])
def test_reference_checkpoint_restores_in_port_with_equal_bits(tmp_path,
                                                               arch):
    rcfg, params, state, tcfg, _ = _trained_pair(arch)
    rckpt.save(str(tmp_path), 1, params, state, extra={"cursor": 1})
    fresh = TG.init_params(tcfg, torch.Generator().manual_seed(9))
    p2, o2, mf = tckpt.restore(str(tmp_path), tckpt.latest_step(
        str(tmp_path)), fresh, tadamw.AdamW().init(fresh))
    assert p2 is fresh and mf["extra"] == {"cursor": 1}
    own = dict(tadamw.named_leaves(p2))
    for n, a in _names(params).items():
        assert np.array_equal(own[n].detach().numpy(), a), n
    assert int(o2.step) == int(state.step) == 1
    for field in ("m", "v"):
        for n, a in _names(getattr(state, field)).items():
            assert np.array_equal(getattr(o2, field)[n].numpy(), a), n


@pytest.mark.parametrize("arch", ["gat-cora", "graphcast"])
def test_port_checkpoint_restores_in_reference_with_equal_bits(tmp_path,
                                                               arch):
    rcfg, params, state, tcfg, _ = _trained_pair(arch)
    model = convert.gnn_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    t_state = convert.adamw_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state), model)
    tckpt.save(str(tmp_path), 5, model, t_state, extra={"cursor": 5})
    blank = RG.init_params(rcfg, jr.PRNGKey(3))
    p2, o2, mf = rckpt.restore(str(tmp_path), 5, blank,
                               radamw.AdamW().init(blank))
    assert mf["extra"] == {"cursor": 5}
    own = dict(tadamw.named_leaves(model))
    for n, a in _names(p2).items():
        assert np.array_equal(a, own[n].detach().numpy()), n
    for field in ("m", "v"):
        for n, a in _names(getattr(o2, field)).items():
            assert np.array_equal(a, getattr(t_state, field)[n].numpy()), n
    assert int(o2.step) == 1


# ----------------------------------------------------------------- CLI


IMPORT_CHECK = (
    "import sys; import repro_torch.models.gnn, "
    "repro_torch.graph.sampler, repro_torch.data.pipeline, "
    "repro_torch.train.steps, repro_torch.launch.specs, "
    "repro_torch.launch.train, repro_torch.convert, "
    "repro_torch.configs.gcn_cora, repro_torch.configs.gat_cora, "
    "repro_torch.configs.pna, repro_torch.configs.graphcast; "
    "bad = [m for m in sys.modules if m == 'jax' or "
    "m.startswith(('jax.', 'repro.'))] + "
    "(['repro'] if 'repro' in sys.modules else []); "
    "assert not bad, bad")


@pytest.fixture(scope="module")
def subprocesses(tmp_path_factory):
    """The CLI on gcn-cora and graphcast and the import check, started
    together: {name: (completed run, its checkpoint directory)}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for arch in ("gcn-cora", "graphcast"):
        d = tmp_path_factory.mktemp(arch)
        runs[arch] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--device", "cpu", "--steps", "3", "--ckpt-dir", str(d)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=d), d)
    runs["imports"] = (subprocess.Popen(
        [sys.executable, "-c", IMPORT_CHECK], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env), None)
    out = {}
    for name, (proc, d) in runs.items():
        stdout, stderr = proc.communicate(timeout=120)
        out[name] = (proc.returncode, stdout, stderr, d)
    return out


@pytest.mark.parametrize("arch", ["gcn-cora", "graphcast"])
def test_train_cli_runs_a_gnn(subprocesses, arch):
    """``python -m repro_torch.launch.train --arch <gnn> --device cpu
    --steps 3 --ckpt-dir d`` logs three finite losses and checkpoints."""
    rc, stdout, stderr, d = subprocesses[arch]
    assert rc == 0, stderr
    lines = [ln for ln in stdout.splitlines() if " loss " in ln]
    assert [ln.split()[2] for ln in lines] == ["0", "1", "2"]
    assert all(np.isfinite(float(ln.split()[4])) for ln in lines)
    assert tckpt.latest_step(str(d)) == 2


def test_gnn_modules_import_no_jax(subprocesses):
    rc, _, stderr, _ = subprocesses["imports"]
    assert rc == 0, stderr
