"""The port's index build held against the JAX reference on the oracle
zoo: the dense Alg-2 HP table (keys equal, values to 1e-5, entries
within float32 rounding of theta counted), ``build_index(exact_d=True)``,
the pair queries on the result, and the Alg-4 walk diagonal held to
its certificate |d~ - d| <= eps_d. ``build_index`` takes the
reference's positional order through ``builder``."""
import dataclasses

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.core import hp_index as rhp
from repro.core import theory as rtheory
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core import diagonal as tdiagonal
from repro_torch.core import hp_index as thp
from repro_torch.core import theory as ttheory
from repro_torch.core import walks as twalks
from repro_torch.graph import generators as tgen

ZOO = tuple(oracle.cases())
ATOL = 1e-5


def _graphs(name):
    r = oracle.cases()[name]
    return r, convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)


def _entries(keys, vals):
    """{(row, key): value} of a packed table."""
    rows, cols = np.nonzero(keys != rhp.INT32_PAD_KEY)
    return dict(zip(zip(rows.tolist(), keys[rows, cols].tolist()),
                    vals[rows, cols].tolist()))


@pytest.mark.parametrize("eps", [0.1, 0.05])
@pytest.mark.parametrize("name", ZOO)
def test_hp_table_matches_reference(name, eps):
    r, t = _graphs(name)
    p = rtheory.plan(eps=eps, c=0.6, n=r.n)
    ref = rhp.build_hp_table(r, p.theta, p.sqrt_c, p.l_max, block=16)
    got = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=16,
                             device="cpu")
    e_ref = _entries(ref.keys, ref.vals)
    e_got = _entries(got.keys.numpy(), got.vals.numpy())
    # entries on one side only must sit within float32 rounding of theta
    only = [(k, v) for k, v in e_ref.items() if k not in e_got] + \
        [(k, v) for k, v in e_got.items() if k not in e_ref]
    boundary = [k for k, v in only if abs(v - p.theta) <= 4e-7 * p.theta]
    assert len(boundary) == len(only), only
    assert len(only) <= 0.001 * len(e_ref)
    shared = [k for k in e_ref if k in e_got]
    np.testing.assert_allclose([e_got[k] for k in shared],
                               [e_ref[k] for k in shared], atol=ATOL, rtol=0)
    if not only:
        np.testing.assert_array_equal(got.keys.numpy(), ref.keys)
        np.testing.assert_array_equal(got.counts.numpy(), ref.counts)
        assert got.width == ref.width


def test_hp_table_block_size_does_not_change_entries():
    _, t = _graphs("powerlaw")
    p = ttheory.plan(eps=0.05, c=0.6, n=t.n)
    a = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=7,
                           device="cpu")
    b = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=64,
                           device="cpu")
    assert torch.equal(a.keys, b.keys) and torch.equal(a.vals, b.vals)
    assert a.entries(5) == [(k // t.n, k % t.n, v) for k, v in zip(
        a.keys[5, :int(a.counts[5])].tolist(),
        a.vals[5, :int(a.counts[5])].tolist())]


def test_capacity_bucket_matches_reference():
    for x in (0, 1, 50, 51, 64, 1000, 4097):
        assert thp.capacity_bucket(x) == rhp.capacity_bucket(x)


@pytest.fixture(scope="module")
def built():
    out = {}
    for name in ZOO:
        r, t = _graphs(name)
        out[name] = (rbuild.build_index(r, eps=0.1, exact_d=True),
                     tbuild.build_index(t, eps=0.1, exact_d=True,
                                        device="cpu"))
    return out


@pytest.mark.parametrize("name", ZOO)
def test_build_index_exact_d_matches_reference(built, name):
    ri, ti = built[name]
    assert ti.plan == convert.index_from_arrays(
        __import__("dataclasses").asdict(ri.plan), ri.d, ri.hp.keys,
        ri.vals_f32(), ri.hp.counts, device="cpu").plan
    np.testing.assert_allclose(ti.d.numpy(), ri.d, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ti.hp.keys.numpy(), ri.hp.keys)
    np.testing.assert_allclose(ti.hp.vals.numpy(), ri.hp.vals, atol=ATOL,
                               rtol=0)
    assert ti.build_seconds.keys() == {"d", "hp"}


PLAN_ARGS = (0.1, 1e-3, 0.5)     # eps, delta, c: c = 0.001 if misread


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_build_index_argument_order_matches_reference(how):
    """``build_index(g, eps, delta, c)`` reads its arguments as the
    reference does, by position and by keyword: the plan equals the
    reference build's and ``theory.plan``'s, field for field."""
    r, t = _graphs("powerlaw")
    eps, delta, c = PLAN_ARGS
    if how == "positional":
        ti = tbuild.build_index(t, eps, delta, c, exact_d=True,
                                device="cpu")
        ri = rbuild.build_index(r, eps, delta, c, exact_d=True)
    else:
        ti = tbuild.build_index(t, eps=eps, delta=delta, c=c, exact_d=True,
                                device="cpu")
        ri = rbuild.build_index(r, eps=eps, delta=delta, c=c, exact_d=True)
    want = dataclasses.asdict(rtheory.plan(eps=eps, delta=delta, c=c,
                                           n=r.n))
    assert dataclasses.asdict(ri.plan) == want
    got = dataclasses.asdict(ti.plan)
    assert got == {k: want[k] for k in got}
    assert ti.plan.c == c and ti.plan.delta == delta
    np.testing.assert_array_equal(ti.hp.keys.numpy(), ri.hp.keys)


def test_build_index_passes_delta_and_adaptive_to_the_walks(monkeypatch):
    """A positional ``delta`` reaches the plan that sizes the walks, and
    a positional ``adaptive`` reaches ``estimate_diagonal``: the build's
    d equals a direct Algorithm-1 estimate on the same seed."""
    _, t = _graphs("powerlaw")
    seen = []
    real = tdiagonal.estimate_diagonal

    def spy(g, plan, seed=0, adaptive=True, **kw):
        seen.append((plan, seed, adaptive))
        return real(g, plan, seed=seed, adaptive=adaptive, **kw)

    monkeypatch.setattr(tbuild.diagonal, "estimate_diagonal", spy)
    idx = tbuild.build_index(t, 0.3, 0.01, 0.6, 5, False, 16, device="cpu")
    (plan, seed, adaptive), = seen
    assert plan == idx.plan and plan.delta == 0.01 and seed == 5
    assert adaptive is False
    assert plan.n_r1 != ttheory.plan(eps=0.3, c=0.6, n=t.n).n_r1
    monkeypatch.undo()
    direct = tdiagonal.estimate_diagonal(t, plan, seed=5, adaptive=False,
                                         device="cpu")
    np.testing.assert_array_equal(idx.d.numpy(), direct)


def test_build_index_takes_nothing_positional_after_block():
    """The reference's positional parameters run through ``builder``
    (``spill_dir`` eighth, ``builder`` fourteenth), which the port takes
    in the same order; its own ``device`` and ``verbose`` are
    keyword-only, so a fifteenth positional argument is refused."""
    _, t = _graphs("powerlaw")
    args = (0.1, None, 0.6, 0, True, 16, None, False, False, True, 0.0,
            0.0, "sling")
    assert tbuild.build_index(t, *args, device="cpu").builder == "sling"
    with pytest.raises(TypeError):
        tbuild.build_index(t, *args, "cpu")


@pytest.mark.parametrize("name", ZOO)
def test_pair_queries_match_reference(built, name):
    ri, ti = built[name]
    rng = np.random.default_rng(0)
    us = rng.integers(0, ri.n, 64)
    vs = rng.integers(0, ri.n, 64)
    np.testing.assert_allclose(ti.query_pairs(us, vs, device="cpu"),
                               ri.query_pairs(us, vs), atol=ATOL, rtol=0)
    for u, v in zip(us[:8], vs[:8]):
        assert ti.query_pair_host(int(u), int(v)) == pytest.approx(
            ri.query_pair_host(int(u), int(v)), abs=1e-9)


@pytest.mark.parametrize("name", ZOO)
def test_walk_diagonal_within_eps_d(name):
    _, t = _graphs(name)
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    exact = tdiagonal.exact_diagonal(t, 0.6)
    d = tdiagonal.estimate_diagonal(t, p, seed=11, device="cpu",
                                    chunk=1 << 16)
    assert d.dtype == np.float32 and d.shape == (t.n,)
    assert np.abs(d - exact).max() <= p.eps_d
    deg = t.in_deg
    np.testing.assert_array_equal(d[deg == 0], 1.0)
    np.testing.assert_allclose(d[deg == 1], 0.4, atol=1e-7)


def test_alg1_diagonal_within_eps_d():
    _, t = _graphs("powerlaw")
    p = ttheory.plan(eps=0.1, c=0.6, n=t.n)
    d = tdiagonal.estimate_diagonal(t, p, seed=3, adaptive=False,
                                    device="cpu")
    assert np.abs(d - tdiagonal.exact_diagonal(t, 0.6)).max() <= p.eps_d


def test_walk_diagonal_is_deterministic_in_seed():
    g = tgen.barabasi_albert(40, 3, seed=2, directed=False)
    p = ttheory.plan(eps=0.1, c=0.6, n=g.n)
    a = tdiagonal.estimate_diagonal(g, p, seed=5, device="cpu")
    b = tdiagonal.estimate_diagonal(g, p, seed=5, device="cpu")
    c = tdiagonal.estimate_diagonal(g, p, seed=5, device="cpu",
                                    chunk=1 << 12)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() <= 2 * p.eps_d


def test_paired_meet_semantics():
    g = tgen.with_sinks(30, 80, n_sinks=4, seed=1)
    dg = twalks.DeviceGraph.from_graph(g, "cpu")
    gen = torch.Generator().manual_seed(0)
    sinks = torch.as_tensor(np.flatnonzero(g.in_deg == 0))
    # identical starts meet at step 0; two distinct sinks never move
    same = twalks.paired_meet(dg, sinks, sinks, gen, 0.77, 20)
    assert bool(same.all())
    apart = twalks.paired_meet(dg, sinks[:2], sinks[1:3], gen, 0.77, 20)
    assert not bool(apart.any())


def test_meeting_rate_estimates_simrank():
    """Lemma 3: the fraction of walk pairs that meet is s(u, v)."""
    r, t = _graphs("powerlaw")
    S = oracle.exact_simrank(r, 0.6)
    dg = twalks.DeviceGraph.from_graph(t, "cpu")
    gen = torch.Generator().manual_seed(1)
    W = 200_000
    met = twalks.paired_meet(dg, torch.full((W,), 3), torch.full((W,), 9),
                             gen, 0.6 ** 0.5, twalks.default_t_max(0.6 ** 0.5))
    assert abs(met.double().mean().item() - S[3, 9]) < 0.005
