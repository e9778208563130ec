"""The port's baselines and small public names held against the
reference: the Monte Carlo and Linearize baselines, ``power.
single_pair``, the grid / cycle / star generators, ``Graph.out_deg`` /
``out_neighbors``, ``theory.phase2_pairs`` and ``single_source_naive``,
on the oracle zoo (tests/oracle.py) with inputs made from seeds."""
import dataclasses

import numpy as np
import pytest
import torch

import oracle
from repro.baselines import linearize as rlin
from repro.baselines import montecarlo as rmc
from repro.baselines import power as rpower
from repro.core import build as rbuild
from repro.core import single_source as rss
from repro.core import theory as rtheory
from repro.graph import generators as rgen
from repro_torch import convert
from repro_torch.baselines import linearize as tlin
from repro_torch.baselines import montecarlo as tmc
from repro_torch.baselines import power as tpower
from repro_torch.core import single_source as tss
from repro_torch.core import theory as ttheory
from repro_torch.graph import generators as tgen

ZOO = tuple(oracle.cases())
CSR_FIELDS = ("n", "m", "in_ptr", "in_idx", "out_ptr", "out_idx",
              "edge_dst", "edge_src")
TOL_MC = 1e-12
TOL_LIN = 1e-10


def _port_zoo():
    """tests/oracle.py's zoo, built with the port's generators."""
    return {
        "er": tgen.erdos_renyi(48, 150, seed=3, directed=True),
        "powerlaw": tgen.barabasi_albert(64, 3, seed=1, directed=False),
        "dag": tgen.dag(40, 110, seed=5),
        "sinks": tgen.with_sinks(40, 120, n_sinks=5, seed=7),
        "multigraph": tgen.multigraph(32, 90, seed=9),
    }


def _pair(name):
    return oracle.cases()[name], _port_zoo()[name]


def _sample(n, seed, k=40):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, k), rng.integers(0, n, k)


# ----------------------------------------------------------------------
# generators, CSR, theory, power
# ----------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda gen: gen.grid2d(5, 7), lambda gen: gen.grid2d(1, 9),
    lambda gen: gen.cycle(4), lambda gen: gen.cycle(11),
    lambda gen: gen.star(2), lambda gen: gen.star(17)],
    ids=["grid5x7", "grid1x9", "cycle4", "cycle11", "star2", "star17"])
def test_grid_cycle_star_equal_reference(make):
    r, t = make(rgen), make(tgen)
    for f in CSR_FIELDS:
        a, b = getattr(r, f), getattr(t, f)
        if isinstance(a, int):
            assert a == b, f
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("name", ZOO)
def test_out_degrees_and_neighbors_equal_reference(name):
    r, t = _pair(name)
    assert np.array_equal(r.out_deg, t.out_deg)
    assert t.out_deg.sum() == t.m
    for v in range(r.n):
        np.testing.assert_array_equal(r.out_neighbors(v), t.out_neighbors(v))


def test_phase2_pairs_equals_reference():
    for mu in (0.0, 1e-4, 0.01, 0.3, 0.9):
        for eps_d in (0.005, 0.02, 0.1):
            for delta_d in (1e-6, 1e-3, 0.1):
                for c in (0.4, 0.6, 0.8):
                    want = rtheory.phase2_pairs(mu, eps_d, delta_d, c)
                    got = ttheory.phase2_pairs(mu, eps_d, delta_d, c)
                    assert type(got) is int and got == want


@pytest.mark.parametrize("name", ZOO)
def test_power_single_pair_equals_reference(name):
    r, t = _pair(name)
    us, vs = _sample(r.n, 5, k=4)
    for c, iters in ((0.6, 50), (0.8, 20)):
        for u, v in zip(us, vs):
            assert tpower.single_pair(t, int(u), int(v), c, iters) == \
                rpower.single_pair(r, int(u), int(v), c, iters)


# ----------------------------------------------------------------------
# Monte Carlo
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ZOO)
def test_mc_walks_equal_reference_bit_for_bit(name):
    r, t = _pair(name)
    for eps, seed, n_w in ((0.2, 0, 64), (0.1, 7, 200)):
        a = rmc.build(r, eps=eps, seed=seed, n_w_override=n_w)
        b = tmc.build(t, eps=eps, seed=seed, n_w_override=n_w,
                      device="cpu")
        assert (b.c, b.t, b.n_w) == (a.c, a.t, a.n_w)
        assert b.walks.dtype == torch.int32
        np.testing.assert_array_equal(b.walks.numpy(), a.walks)
        assert b.nbytes() == a.nbytes()


def test_mc_params_and_default_build_equal_reference():
    r, t = _pair("er")
    for eps, delta, n, c in ((0.025, 1e-3, 10**6, 0.6), (0.2, 0.01, 48, 0.8),
                             (0.5, 0.5, 1, 0.4)):
        assert tmc.params_for(eps, delta, n, c) == \
            rmc.params_for(eps, delta, n, c)
    a = rmc.build(r, eps=0.5, seed=1)           # n_w from the formula
    b = tmc.build(t, eps=0.5, seed=1, device="cpu")
    np.testing.assert_array_equal(b.walks.numpy(), a.walks)


@pytest.mark.parametrize("name", ZOO)
def test_mc_answers_match_reference(name):
    r, t = _pair(name)
    a = rmc.build(r, eps=0.1, seed=3, n_w_override=300)
    b = tmc.build(t, eps=0.1, seed=3, n_w_override=300, device="cpu")
    us, vs = _sample(r.n, 1)
    vs[:4] = us[:4]                             # (u, u) is 1
    for u, v in zip(us, vs):
        assert abs(tmc.query_pair(b, int(u), int(v))
                   - rmc.query_pair(a, int(u), int(v))) <= TOL_MC
    for u in range(0, r.n, 5):
        got = tmc.query_single_source(b, u)
        assert got.dtype == np.float64 and got[u] == 1.0
        np.testing.assert_allclose(got, rmc.query_single_source(a, u),
                                   atol=TOL_MC, rtol=0)


def test_mc_error_within_eps_on_the_reference_graph(ground_truth):
    """The reference's own accuracy test, on the port's index."""
    g = tgen.barabasi_albert(150, 3, seed=1, directed=False)
    mc = tmc.build(g, eps=0.1, seed=0, n_w_override=4000, device="cpu")
    rng = np.random.default_rng(0)
    us, vs = rng.integers(0, g.n, 40), rng.integers(0, g.n, 40)
    errs = [abs(tmc.query_pair(mc, int(u), int(v)) - ground_truth[u, v])
            for u, v in zip(us, vs)]
    assert max(errs) <= 0.1
    assert mc.walks.shape == (g.n, 4000, mc.t + 1)


# ----------------------------------------------------------------------
# Linearize
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ZOO)
def test_linearize_occupancies_and_system_match_reference(name):
    r, t = _pair(name)
    ps_r = rlin.estimate_occupancies(r, 6, 30, seed=4)
    ps_t = tlin.estimate_occupancies(t, 6, 30, seed=4, device="cpu")
    assert len(ps_t) == len(ps_r)
    for a, b in zip(ps_r, ps_t):
        assert b.dtype == torch.float64
        np.testing.assert_allclose(b.numpy(), a, atol=TOL_LIN, rtol=0)
    for R in (None, 30):
        np.testing.assert_allclose(
            tlin.system_matrix(t, 0.6, 6, R, 4, device="cpu").numpy(),
            rlin.system_matrix(r, 0.6, 6, R, 4), atol=TOL_LIN, rtol=0)


@pytest.mark.parametrize("name", ZOO)
def test_linearize_answers_match_reference(name):
    r, t = _pair(name)
    for R, L in ((100, 3), (None, 5)):
        a = rlin.build(r, R=R, L=L, seed=2)
        b = tlin.build(t, R=R, L=L, seed=2, device="cpu")
        assert (b.c, b.T) == (a.c, a.T)
        np.testing.assert_allclose(b.D.numpy(), a.D, atol=TOL_LIN, rtol=0)
        us, vs = _sample(r.n, 2, k=24)
        vs[:2] = us[:2]
        for u, v in zip(us, vs):
            assert abs(tlin.query_pair(b, t, int(u), int(v))
                       - rlin.query_pair(a, r, int(u), int(v))) <= TOL_LIN
        for u in range(0, r.n, 6):
            np.testing.assert_allclose(tlin.query_single_source(b, t, u),
                                       rlin.query_single_source(a, r, u),
                                       atol=TOL_LIN, rtol=0)


def test_linearize_gauss_seidel_matches_reference():
    rng = np.random.default_rng(11)
    M = rng.uniform(0, 1, (20, 20)) + 20 * np.eye(20)
    for iters in (1, 3, 8):
        Dr, res_r = rlin.gauss_seidel(M, iters)
        Dt, res_t = tlin.gauss_seidel(torch.as_tensor(M), iters)
        np.testing.assert_array_equal(Dt.numpy(), Dr)
        assert res_t == res_r


def test_linearize_appendix_a_margin_is_negative_in_both():
    """The directed 4-cycle loses diagonal dominance at c = 0.6 (paper
    Appendix A / Figure 8), with the same margin in both packages."""
    want = rlin.system_matrix_dd_margin(
        rlin.system_matrix(rgen.cycle(4), c=0.6, T=60, R=None))
    got = tlin.system_matrix_dd_margin(
        tlin.system_matrix(tgen.cycle(4), c=0.6, T=60, R=None,
                           device="cpu"))
    assert got < 0 and want < 0
    assert abs(got - want) <= TOL_LIN
    M = np.array([[2.0, -1.0], [0.5, -3.0]])
    assert tlin.system_matrix_dd_margin(M) == \
        rlin.system_matrix_dd_margin(M)


def test_linearize_error_on_the_reference_graph(ground_truth):
    """The reference's benign-graph accuracy test, on the port."""
    g = tgen.barabasi_albert(150, 3, seed=1, directed=False)
    lin = tlin.build(g, R=200, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    us, vs = rng.integers(0, g.n, 30), rng.integers(0, g.n, 30)
    errs = [abs(tlin.query_pair(lin, g, int(u), int(v)) - ground_truth[u, v])
            for u, v in zip(us, vs)]
    assert max(errs) <= 0.05
    assert np.abs(tlin.query_single_source(lin, g, 3)
                  - ground_truth[3]).max() <= 0.05


# ----------------------------------------------------------------------
# single_source_naive
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ZOO)
def test_single_source_naive_matches_reference(name):
    r = oracle.cases()[name]
    ri = rbuild.build_index(r, eps=0.1, exact_d=True)
    tg = convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)
    ti = convert.index_from_arrays(dataclasses.asdict(ri.plan), ri.d,
                                   ri.hp.keys, ri.vals_f32(), ri.hp.counts,
                                   device="cpu")
    S = oracle.exact_simrank(r, ri.plan.c)
    for u in (0, r.n // 2, r.n - 1):
        got = tss.single_source_naive(ti, tg, u, device="cpu")
        assert got.shape == (r.n,) and got.dtype == np.float64
        np.testing.assert_allclose(got, rss.single_source_naive(ri, r, u),
                                   atol=oracle.BACKEND_ATOL, rtol=0)
        off = np.arange(r.n) != u
        assert np.abs(got - S[u])[off].max() <= oracle.tolerance(ri.plan)
