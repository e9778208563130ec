"""The port's xDeepFM serving path held against the JAX reference on the
CPU, at ``xdeepfm.smoke()`` size: configs, FLOP counts, data, the click
graph, embeddings, the CIN stack (plain, and the reference's Pallas
kernel in interpret mode), forward, the serve and retrieval steps, the
SimRank-prior retrieval end to end, and the warm device-state cache.

Inputs come from NumPy seeds and go to both packages; parameters are
the reference's ``init_params``, carried by
``convert.recsys_params_from_jax``.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from repro.configs import xdeepfm as rxdeepfm
from repro.core import build as rbuild
from repro.core import single_source as rss
from repro.core import topk as rtopk
from repro.data import pipeline as rpipeline
from repro.graph import generators as rgen
from repro.kernels.cin import ops as rcin
from repro.launch import specs as rspecs
from repro.models import embeddings as remb
from repro.models import recsys as R
from repro.train import steps as rsteps
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import xdeepfm as txdeepfm
from repro_torch.core import build as tbuild
from repro_torch.core import device_state
from repro_torch.core import single_source as tss
from repro_torch.core import topk as ttopk
from repro_torch.core import update as tupdate
from repro_torch.data import pipeline as tpipeline
from repro_torch.graph import generators as tgen
from repro_torch.kernels import cin as tcin
from repro_torch.launch import specs as tspecs
from repro_torch.models import embeddings as temb
from repro_torch.models import recsys as T
from repro_torch.train import steps as tsteps

TOL = 2e-5        # float32 reduction order (tests/test_kernels.py:62)
EMB_TOL = 1e-6    # gathers and bag reductions
CSR_FIELDS = ("n", "m", "in_ptr", "in_idx", "out_ptr", "out_idx",
              "edge_dst", "edge_src")


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    dt = d["dtype"]
    d["dtype"] = str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name
    return d


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_fields_and_param_count_equal_reference(which):
    t, r = getattr(txdeepfm, which)(), getattr(rxdeepfm, which)()
    assert _fields(t) == _fields(r)
    assert t.param_count() == r.param_count()
    spec = tbase.get("xdeepfm")
    assert spec.family == "recsys" and spec.shapes == \
        ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
    assert _fields(getattr(spec, which)()) == _fields(r)


def test_full_width_param_count():
    assert txdeepfm.full().param_count() == 432_742_000


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_model_flops_equal_reference(which):
    t, r = getattr(txdeepfm, which)(), getattr(rxdeepfm, which)()
    assert tspecs.RECSYS_SHAPE_DEFS == rspecs.RECSYS_SHAPE_DEFS
    for shape in tspecs.RECSYS_SHAPE_DEFS.values():
        batch = shape.get("batch", shape.get("n_candidates"))
        for train in (False, True):
            assert tspecs.recsys_model_flops(t, batch, train) == \
                rspecs.recsys_model_flops(r, batch, train)


@pytest.mark.parametrize("mh", [0, 2])
def test_recsys_stream_equals_reference(mh):
    kw = dict(n_fields=39, vocab=1_000_000, batch=64, multi_hot_fields=mh,
              bag_size=8, seed=3)
    ts, rs = tpipeline.RecsysStream(**kw), rpipeline.RecsysStream(**kw)
    for step in (0, 1, 21):
        a, b = ts.batch_at(step), rs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("sizes", [(60, 80, 600, 0), (500, 900, 4000, 2)])
def test_bipartite_equals_reference(sizes):
    t, r = tgen.bipartite(*sizes[:3], seed=sizes[3]), \
        rgen.bipartite(*sizes[:3], seed=sizes[3])
    for f in CSR_FIELDS:
        x, y = getattr(t, f), getattr(r, f)
        assert np.array_equal(x, y) and np.asarray(x).dtype == \
            np.asarray(y).dtype, f


def _table(rng, V=50, D=6):
    return rng.normal(size=(V, D)).astype(np.float32)


def test_lookup_and_field_lookup_all_equal_reference():
    rng = np.random.default_rng(0)
    table = _table(rng)
    ids = rng.integers(0, 50, (7, 3)).astype(np.int32)
    np.testing.assert_allclose(
        temb.lookup(torch.as_tensor(table), ids).numpy(),
        np.asarray(remb.lookup(jnp.asarray(table), jnp.asarray(ids))),
        atol=EMB_TOL, rtol=0)
    tables = rng.normal(size=(5, 40, 4)).astype(np.float32)
    fids = rng.integers(0, 40, (9, 5)).astype(np.int32)
    np.testing.assert_allclose(
        temb.field_lookup_all(torch.as_tensor(tables), fids).numpy(),
        np.asarray(remb.field_lookup_all(jnp.asarray(tables),
                                         jnp.asarray(fids))),
        atol=EMB_TOL, rtol=0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_equals_reference(mode, weighted):
    """Unsorted bag ids, and bags 2 and 6 of 8 empty."""
    rng = np.random.default_rng(1)
    table = _table(rng)
    ids = rng.integers(0, 50, 30).astype(np.int32)
    bags = rng.choice([0, 1, 3, 4, 5, 7], 30).astype(np.int32)
    w = rng.uniform(0.1, 2.0, 30).astype(np.float32) if weighted else None
    got = temb.embedding_bag(torch.as_tensor(table), ids, bags, 8,
                             mode=mode, weights=w).numpy()
    ref = np.asarray(remb.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), 8,
        mode=mode, weights=None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, atol=EMB_TOL, rtol=0)
    empty = got[[2, 6]]
    assert np.all(empty == (-np.inf if mode == "max" else 0.0))


def _cin_inputs(b, m, d, layers):
    rng = np.random.default_rng(b * m + d + layers)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    hs = [m] + [6] * layers
    Ws = [(rng.normal(size=(hs[i + 1], hs[i], m)) * 0.2).astype(np.float32)
          for i in range(layers)]
    return x0, Ws


CIN_GRID = [(b, m, d, layers) for b in (16, 64) for m in (4, 8)
            for d in (4, 8) for layers in (1, 3)] + [(13, 5, 3, 3)]


@pytest.mark.parametrize("case", CIN_GRID, ids=str)
def test_cin_forward_equals_reference(case):
    x0, Ws = _cin_inputs(*case)
    got = tcin.cin_forward(torch.as_tensor(x0),
                           [torch.as_tensor(w) for w in Ws])
    assert tcin.cin_layer.launches == 0     # the CPU takes the plain layer
    ref = rcin.cin_forward_reference(jnp.asarray(x0),
                                     [jnp.asarray(w) for w in Ws])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("case", [(16, 4, 4, 1), (64, 8, 8, 3)], ids=str)
def test_cin_forward_equals_reference_pallas_kernel(case):
    x0, Ws = _cin_inputs(*case)
    got = tcin.cin_forward(torch.as_tensor(x0),
                           [torch.as_tensor(w) for w in Ws])
    ref = rcin.cin_forward(jnp.asarray(x0), [jnp.asarray(w) for w in Ws],
                           bb=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_cin_backends_and_shape_checks():
    x0, Ws = _cin_inputs(13, 5, 3, 1)
    x0t, Wt = torch.as_tensor(x0), torch.as_tensor(Ws[0])
    assert torch.equal(tcin.cin_layer(x0t, x0t, Wt),
                       tcin.cin_layer(x0t, x0t, Wt, backend="plain"))
    with pytest.raises(ValueError, match="backend"):
        tcin.cin_layer(x0t, x0t, Wt, backend="pallas")
    with pytest.raises(ValueError, match="shapes"):
        tcin.cin_layer(x0t, x0t, Wt[:, :4])
    with pytest.raises(TypeError, match="float32"):
        tcin.cin_layer(x0t.double(), x0t.double(), Wt.double())


def _model(sim_prior=False):
    rcfg = dataclasses.replace(rxdeepfm.smoke(), sim_prior=sim_prior)
    tcfg = dataclasses.replace(txdeepfm.smoke(), sim_prior=sim_prior)
    params = R.init_params(rcfg, jr.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model = convert.recsys_params_from_jax(tcfg, params_np, device="cpu")
    return rcfg, params, tcfg, model


def test_converted_parameters_keep_reference_names():
    _, params, _, model = _model(sim_prior=True)
    names = dict(model.named_parameters())
    assert {"tables.embed", "tables.linear", "recsys.cin_w.0",
            "recsys.cin_w.1", "recsys.mlp_w.0", "recsys.mlp_b.1",
            "recsys.mlp_out", "recsys.cin_out", "recsys.bias",
            "recsys.sim_w"} <= set(names)
    np.testing.assert_array_equal(names["recsys.cin_w.1"].numpy(),
                                  np.asarray(params["recsys"]["cin_w"][1]))
    assert not any(p.requires_grad for p in names.values())


def test_native_init_shapes_and_scales():
    cfg = txdeepfm.smoke()
    m = T.XDeepFM(cfg, generator=torch.Generator().manual_seed(0))
    assert m.device.type == "cpu"
    n = sum(p.numel() for p in m.parameters())
    assert n == cfg.param_count() + 1                  # + the scalar bias
    assert 0.005 < float(m.tables["embed"].std()) < 0.02
    again = T.XDeepFM(cfg, generator=torch.Generator().manual_seed(0))
    assert torch.equal(m.recsys.cin_w[1], again.recsys.cin_w[1])


@pytest.mark.parametrize("multi_hot", [False, True])
def test_forward_and_serve_step_equal_reference(multi_hot):
    rcfg, params, tcfg, model = _model()
    batch = rpipeline.RecsysStream(
        rcfg.n_fields, rcfg.vocab_per_field, 24,
        multi_hot_fields=rcfg.multi_hot_fields if multi_hot else 0,
        bag_size=rcfg.bag_size, seed=5).batch_at(2)
    assert ("mh_ids" in batch) == multi_hot
    ref = np.asarray(R.forward(rcfg, params, {k: jnp.asarray(v)
                                              for k, v in batch.items()}))
    got = T.forward(tcfg, model, batch).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    ref_p = np.asarray(rsteps.recsys_serve_step(rcfg)(params, batch))
    got_p = tsteps.recsys_serve_step(tcfg)(model, batch).numpy()
    np.testing.assert_allclose(got_p, ref_p, atol=TOL, rtol=TOL)
    # the override replaced the multi-hot slots: without mh_ids it differs
    if multi_hot:
        plain = T.forward(tcfg, model, {"ids": batch["ids"]}).numpy()
        assert not np.allclose(plain, got)


def test_retrieval_step_equals_reference_with_planted_ties():
    rcfg, params, tcfg, model = _model()
    rng = np.random.default_rng(9)
    C = 300
    rb = {"user_ids": rng.integers(0, rcfg.vocab_per_field,
                                   rcfg.n_user_fields).astype(np.int32),
          "cand_ids": rng.integers(
              0, rcfg.vocab_per_field,
              (C, rcfg.n_fields - rcfg.n_user_fields)).astype(np.int32)}
    best = int(np.argmax(tsteps.recsys_retrieval_step(tcfg)(
        model, rb)["scores"].numpy()))
    tied = [best, 5, 77, 190, 291]
    rb["cand_ids"][tied] = rb["cand_ids"][best]
    got = tsteps.recsys_retrieval_step(tcfg)(model, rb)
    ref = rsteps.recsys_retrieval_step(rcfg)(params, rb)
    s = got["scores"].numpy()
    assert len(set(s[tied].tolist())) == 1          # the tie is exact
    np.testing.assert_allclose(s, np.asarray(ref["scores"]), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got["top_v"].numpy(),
                               np.asarray(ref["top_v"]), atol=TOL, rtol=TOL)
    assert got["top_i"].dtype == torch.int32 and got["top_i"].shape == (128,)
    np.testing.assert_array_equal(got["top_i"].numpy(),
                                  np.asarray(ref["top_i"]))
    np.testing.assert_array_equal(got["top_i"].numpy()[:5], sorted(tied))


def test_sim_prior_retrieval_end_to_end_equals_reference():
    """tests/test_system.py:91 through both packages: the click graph,
    exact-d builds, single_source_device, fused retrieval."""
    n_users, n_items = 60, 80
    rg = rgen.bipartite(n_users, n_items, 600, seed=0)
    tg = tgen.bipartite(n_users, n_items, 600, seed=0)
    ridx = rbuild.build_index(rg, eps=0.3, exact_d=True)
    tidx = tbuild.build_index(tg, eps=0.3, exact_d=True, device="cpu")
    # a user's SimRank to every item is 0 on a bipartite graph (the two
    # reverse walks are on opposite sides at every step), in both
    # packages; an item the user clicked gives the prior that is not 0
    users = np.array([7, 31])
    sources = np.concatenate([users, [rg.in_neighbors(u)[-1] for u in users]])
    rsim = rss.single_source_device(ridx, rg, sources)
    tsim = tss.single_source_device(tidx, tg, sources, device="cpu")
    np.testing.assert_allclose(tsim, rsim, atol=1e-5, rtol=0)
    assert not rsim[:2, n_users:].any() and not tsim[:2, n_users:].any()
    assert (tsim[2:, n_users:].sum(1) > 0).all()
    tv, ti = ttopk.topk_device(tidx, tg, sources, 10, device="cpu")
    rv, ri = rtopk.topk_device(ridx, rg, sources, 10)
    np.testing.assert_allclose(tv, rv, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tsim[np.arange(4)[:, None], ti], rv,
                               atol=1e-5, rtol=0)

    rcfg, params, tcfg, model = _model(sim_prior=True)
    rng = np.random.default_rng(2)
    user_ids = rng.integers(0, rcfg.vocab_per_field, rcfg.n_user_fields)
    cand_ids = rng.integers(0, rcfg.vocab_per_field,
                            (n_items, rcfg.n_fields - rcfg.n_user_fields))
    w = float(params["recsys"]["sim_w"])
    for row in range(len(sources)):
        ritem = rsim[row, n_users:]
        titem = tsim[row, n_users:]
        rb = {"user_ids": user_ids, "cand_ids": cand_ids}
        r_base = np.asarray(R.score_candidates(
            dataclasses.replace(rcfg, sim_prior=False), params,
            {k: jnp.asarray(v) for k, v in rb.items()}))
        r_fused = np.asarray(R.score_candidates(
            rcfg, params, {**{k: jnp.asarray(v) for k, v in rb.items()},
                           "sim_scores": jnp.asarray(ritem, jnp.float32)}))
        with torch.inference_mode():
            t_base = T.score_candidates(
                dataclasses.replace(tcfg, sim_prior=False), model, rb).numpy()
            t_fused = T.score_candidates(
                tcfg, model, {**rb, "sim_scores": titem}).numpy()
        np.testing.assert_allclose(t_base, r_base, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(t_fused, r_fused, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(t_fused - t_base, w * titem, atol=1e-5)


def _small_index(seed=0):
    g = tgen.barabasi_albert(60, 3, seed=seed, directed=False)
    return g, tbuild.build_index(g, eps=0.2, exact_d=True, device="cpu")


def test_device_state_warm_second_call():
    device_state.cache_clear()
    g, idx = _small_index()
    a = device_state.serving_arrays(idx, g, "cpu")
    assert device_state.serving_arrays(idx, g, "cpu") is a
    assert device_state.cache_len() == 1
    assert a.keys is idx.hp.keys and a.d is idx.d     # no copy
    us = np.array([0, 5, 9])
    first = tss.single_source_device(idx, g, us, device="cpu")
    assert device_state.serving_arrays(idx, g, "cpu") is a
    np.testing.assert_array_equal(
        tss.single_source_device(idx, g, us, device="cpu"), first)
    for u, row in zip(us, first):
        np.testing.assert_allclose(row, tss.single_source_horner(idx, g, u),
                                   atol=1e-5, rtol=0)


def test_device_state_invalidated_by_update_epoch():
    device_state.cache_clear()
    g, idx = _small_index(1)
    us = np.array([1, 2])
    before = device_state.serving_arrays(idx, g, "cpu")
    tss.single_source_device(idx, g, us, device="cpu")
    delta = tupdate.random_delta(g, n_add=8, n_del=8, seed=4)
    rep = tbuild.update_index(idx, g, delta, exact_d=True)
    assert idx.epoch == 1
    # the same graph object: only the epoch tells the entry is stale
    assert device_state.serving_arrays(idx, g, "cpu") is not before
    g2 = rep.graph
    after = tss.single_source_device(idx, g2, us, device="cpu")
    for u, row in zip(us, after):
        np.testing.assert_allclose(row, tss.single_source_horner(idx, g2, u),
                                   atol=1e-5, rtol=0)


def test_device_state_evicts_dead_index_and_caps_lru():
    device_state.cache_clear()
    g, idx = _small_index(2)
    device_state.serving_arrays(idx, g, "cpu")
    assert device_state.cache_len() == 1
    del idx
    gc.collect()
    assert device_state.cache_len() == 0
    g, idx = _small_index(3)
    keep = [convert.index_from_arrays(
        dataclasses.asdict(idx.plan), idx.d.numpy(), idx.hp.keys.numpy(),
        idx.hp.vals.numpy(), idx.hp.counts.numpy(), device="cpu")
        for _ in range(device_state._MAX_ENTRIES + 2)]
    first = device_state.serving_arrays(keep[0], g, "cpu")
    for ii in keep[1:]:
        device_state.serving_arrays(ii, g, "cpu")
    assert device_state.cache_len() == device_state._MAX_ENTRIES
    assert device_state.serving_arrays(keep[0], g, "cpu") is not first
