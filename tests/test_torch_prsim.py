"""The port's PRSim builder held against the JAX reference on the oracle
zoo, on the CPU: reverse PageRank and the hub set, the prsim HP table
(keys and counts equal to the reference's, values to 1e-6), and the
builder contract that the prsim and sling schedules emit the same
triples bit for bit, however the columns are batched."""
import numpy as np
import pytest
import torch

import oracle
from repro import prsim as rprsim
from repro.core import build as rbuild
from repro.core import hp_index as rhp
from repro.core import theory as rtheory
from repro.graph import generators as rgen
from repro_torch import convert
from repro_torch import prsim as tprsim
from repro_torch.core import build as tbuild
from repro_torch.core import hp_index as thp
from repro_torch.core import theory as ttheory

ZOO = tuple(oracle.cases())
GRAPHS = {**{name: (lambda name=name: oracle.cases()[name]) for name in ZOO},
          "powerlaw_fast-600": lambda: rgen.powerlaw_fast(600, seed=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ops here are tiny and dispatch-bound: one intra-op thread
    keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graphs(name):
    r = GRAPHS[name]()
    return r, convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)


def _canonical(src, key, val):
    """Triples sorted by (src, key), values as their float32 bits."""
    src, key = np.asarray(src, np.int64), np.asarray(key, np.int64)
    order = np.lexsort((key, src))
    return (src[order], key[order],
            np.asarray(val, np.float32)[order].view(np.int32))


def _assert_same_bits(a, b):
    for x, y in zip(_canonical(*a), _canonical(*b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", GRAPHS)
def test_reverse_pagerank_and_hub_set_match_reference(name):
    r, t = _graphs(name)
    rpr, riters = rprsim.reverse_pagerank(r)
    tpr, titers = tprsim.reverse_pagerank(t, device="cpu")
    assert tpr.dtype == np.float32 and tpr.shape == (r.n,)
    np.testing.assert_allclose(tpr, np.asarray(rpr), atol=1e-6, rtol=0)
    assert titers == riters
    assert abs(float(tpr.sum()) - 1.0) <= 1e-5
    for mass, cap in ((0.5, 0.05), (0.9, 0.5), (1.0, 1.0)):
        np.testing.assert_array_equal(
            tprsim.hub_set(tpr, mass=mass, cap_frac=cap),
            rprsim.hub_set(np.asarray(rpr), mass=mass, cap_frac=cap))


def test_reverse_pagerank_edge_cap_and_empty_graph():
    r, t = _graphs("er")
    with pytest.raises(ValueError, match="edge_cap"):
        tprsim.reverse_pagerank(t, edge_cap=t.m - 1, device="cpu")
    with pytest.raises(ValueError, match="edge_cap"):
        rprsim.reverse_pagerank(r, edge_cap=r.m - 1)
    np.testing.assert_array_equal(
        tprsim.reverse_pagerank(t, edge_cap=t.m + 100, device="cpu")[0],
        tprsim.reverse_pagerank(t, device="cpu")[0])
    empty = convert.graph_from_arrays(0, np.zeros(0, np.int64),
                                      np.zeros(0, np.int64))
    pr, iters = tprsim.reverse_pagerank(empty, device="cpu")
    assert pr.shape == (0,) and iters == 0
    assert tprsim.hub_set(pr).shape == (0,)


@pytest.mark.parametrize("eps", [0.1, 0.05])
@pytest.mark.parametrize("name", GRAPHS)
def test_prsim_triples_equal_sling_triples_bit_for_bit(name, eps):
    """The hub/tail schedule, the SLING block schedule and one column at
    a time in a shuffled order emit the same triples, bit for bit."""
    _, t = _graphs(name)
    p = ttheory.plan(eps=eps, c=0.6, n=t.n)
    prsim_sink, sling_sink = thp._CooSink(None), thp._CooSink(None)
    stats = tprsim.build_prsim_coo(t, p, prsim_sink, hub_batch=3,
                                   tail_block=11, device="cpu")
    assert 1 <= stats.n_hubs <= t.n and stats.pr_iters >= 1
    thp.sparse_hp_coo(t, p.theta, p.sqrt_c, p.l_max, 16, sling_sink,
                      device="cpu")
    prsim_t = [x.numpy() for x in prsim_sink.collect()]
    sling_t = [x.numpy() for x in sling_sink.collect()]
    _assert_same_bits(prsim_t, sling_t)
    og = thp.OutGraph.from_graph(t, p.sqrt_c, "cpu")
    order = np.random.default_rng(1).permutation(t.n)
    ones = [thp._sparse_targets_coo(og, [v], p.theta, p.l_max)
            for v in order]
    _assert_same_bits([torch.cat([o[i] for o in ones]).numpy()
                       for i in range(3)], sling_t)


@pytest.mark.parametrize("name", GRAPHS)
def test_prsim_table_matches_reference(name):
    r, t = _graphs(name)
    p = rtheory.plan(eps=0.1, c=0.6, n=r.n)
    ref_sink = rhp._CooSink(None)
    rprsim.build_prsim_coo(r, p, ref_sink)
    src, key, val = ref_sink.collect()
    ref = rhp._pack_coo(src, key, val, r.n, None, p.theta, p.sqrt_c,
                        p.l_max)
    got, stats = tbuild._prsim_hp_table(t, ttheory.plan(eps=0.1, c=0.6,
                                                        n=t.n),
                                        None, False, "cpu")
    assert got.width == ref.width
    np.testing.assert_array_equal(got.keys.numpy(), ref.keys)
    np.testing.assert_array_equal(got.counts.numpy(), ref.counts)
    np.testing.assert_allclose(got.vals.numpy(), ref.vals, atol=1e-6,
                               rtol=0)
    rpr, _ = rprsim.reverse_pagerank(r)
    assert stats.n_hubs == len(rprsim.hub_set(np.asarray(rpr)))
    assert set(stats.as_row()) == {"n_hubs", "pr_iters", "hub_mass",
                                   "pr_wall_s", "hub_wall_s",
                                   "tail_wall_s"}


@pytest.mark.parametrize("name", ZOO)
def test_build_index_prsim_equals_reference_and_serves_within_eps(name):
    r, t = _graphs(name)
    ref = rbuild.build_index(r, eps=0.1, exact_d=True, builder="prsim")
    got = tbuild.build_index(t, eps=0.1, exact_d=True, builder="prsim",
                             device="cpu")
    sling = tbuild.build_index(t, eps=0.1, exact_d=True, device="cpu")
    assert got.builder == ref.builder == "prsim" and sling.builder == "sling"
    np.testing.assert_array_equal(got.hp.keys.numpy(), ref.hp.keys)
    np.testing.assert_allclose(got.hp.vals.numpy(), ref.hp.vals, atol=1e-6,
                               rtol=0)
    S = oracle.exact_simrank(r, 0.6)
    tol = oracle.tolerance(got.plan)
    us, vs = np.meshgrid(np.arange(t.n), np.arange(t.n), indexing="ij")
    host = np.array([got.query_pair_host(int(u), int(v))
                     for u, v in zip(us.ravel()[::7], vs.ravel()[::7])])
    assert np.abs(host - S.ravel()[::7]).max() <= tol
