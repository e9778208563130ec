"""The port's eps-charged quantization and Section-5 optimizations held
against the reference: ``plan(eps_quant_frac=)`` and the three bounds
equal field for field; ``quantize_array`` codes and scales equal bit for
bit (int16 and bf16 from ``torch.bfloat16``, seeded arrays, the all-zero
row) with the same refusals; ``quantize_index`` within its certified
bound; a quantized hot-swap adds no shape; ``eta``, ``exact_step12``,
``apply_space_reduction`` and ``mark_for_enhancement`` equal the
reference's; ``build_index(space_reduce=, enhance=, quant_frac=)``
equals the reference's build; and the host single-source on a reduced,
enhanced index is within 1e-5 of the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

import oracle
from repro.core import build as rbuild
from repro.core import optimizations as ropt
from repro.core import quantize as rquant
from repro.core import single_source as rss
from repro.core import theory as rtheory
from repro.core.index import SlingIndex as RIndex
from repro_torch import convert
from repro_torch.core import build as tbuild
from repro_torch.core import optimizations as topt
from repro_torch.core import quantize as tquant
from repro_torch.core import single_source as tss
from repro_torch.core import theory as ttheory
from repro_torch.core.index import SlingIndex as TIndex
from repro_torch.serve import EngineConfig, QueryEngine

ATOL = oracle.BACKEND_ATOL
ZOO = tuple(oracle.cases())


def _carry(ri, tmp_path, name="idx.sling") -> TIndex:
    """The reference index as the port reads its v3 bytes (CPU)."""
    p = str(tmp_path / name)
    ri.save(p)
    return TIndex.load(p, device="cpu")


def _tgraph(g):
    return convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "V" or x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def qgraph():
    from repro.graph import generators
    return generators.barabasi_albert(60, 3, seed=2, directed=False)


@pytest.fixture(scope="module")
def qindex(qgraph):
    return rbuild.build_index(qgraph, eps=0.1, exact_d=True, seed=0,
                              quant_frac=0.25)


# ----------------------------------------------------------------------
# the budget split (theory)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stale", [0.0, 0.2])
@pytest.mark.parametrize("c", [0.4, 0.6, 0.8])
@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_plan_quant_fields_and_bounds_match_reference(c, frac, stale):
    kw = dict(eps=0.1, c=c, n=500, stale_frac=stale, eps_quant_frac=frac)
    rp, tp = rtheory.plan(**kw), ttheory.plan(**kw)
    assert dataclasses.asdict(tp) == dataclasses.asdict(rp)
    for d_channel in (False, True):
        assert ttheory.quant_vals_bound(tp, d_channel) == \
            rtheory.quant_vals_bound(rp, d_channel)
    assert ttheory.quant_d_bound(tp) == rtheory.quant_d_bound(rp)
    b = ttheory.quant_vals_bound(tp, True)
    bd = ttheory.quant_d_bound(tp)
    assert ttheory.quant_charge(tp, b, bd) == rtheory.quant_charge(rp, b,
                                                                   bd)
    # the derived bounds spend exactly the reserve
    assert ttheory.quant_charge(tp, b, bd) == pytest.approx(tp.eps_quant,
                                                            rel=1e-9)


@pytest.mark.parametrize("kw, match", [
    (dict(stale_frac=0.6, eps_quant_frac=0.4), "whole eps budget"),
    (dict(eps_quant_frac=1.0), "eps_quant_frac"),
    (dict(eps_quant_frac=-0.1), "eps_quant_frac")])
def test_plan_refusals_match_reference(kw, match):
    for plan in (rtheory.plan, ttheory.plan):
        with pytest.raises(ValueError, match=match):
            plan(eps=0.1, **kw)


def test_bounds_refuse_without_reserve():
    p = ttheory.plan(eps=0.1)
    assert p.eps_quant == 0.0
    for fn in (ttheory.quant_vals_bound, ttheory.quant_d_bound):
        with pytest.raises(ValueError, match="eps_quant_frac"):
            fn(p)


# ----------------------------------------------------------------------
# quantize_array: codes and scales bit for bit
# ----------------------------------------------------------------------
def _case(name):
    rng = np.random.default_rng(0)
    theta = 0.011
    if name == "hp-like":
        return np.concatenate([
            rng.uniform(0, 1, 500).astype(np.float32),
            np.full(8, theta, np.float32), np.zeros(16, np.float32),
            np.float32([1.0, 1e-6, theta * 1.0000001])]), 0.005
    if name == "signed-2d":
        return rng.uniform(-1, 1, (32, 19)).astype(np.float32), 2.0 ** -7
    if name == "all-zero-row":
        return np.zeros((4, 7), np.float32), 1e-9
    if name == "small-lognormal":
        return (rng.lognormal(-6, 1.5, (40, 33)).astype(np.float32)
                * (rng.random((40, 33)) < 0.7)), 2e-4
    if name == "midpoints":
        # values on int16 rounding midpoints of the scale 1/32767
        k = rng.integers(0, 32767, 2000)
        return np.append((k + 0.5) / 32767, 1.0).astype(np.float32), 1e-3
    raise KeyError(name)


CASES = ("hp-like", "signed-2d", "all-zero-row", "small-lognormal",
         "midpoints")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("scheme", ["int16", "bf16"])
def test_quantize_array_bits_match_reference(scheme, case):
    vals, bound = _case(case)
    # a bound the scheme certifies at this value range
    vmax = float(np.abs(vals).max())
    bound = max(bound, vmax / 32767 if scheme == "int16" else vmax / 256)
    rs, rscale = rquant.quantize_array(vals, scheme, bound)
    ts, tscale = tquant.quantize_array(vals, scheme, bound)
    assert tscale == rscale
    assert ts.dtype == (torch.int16 if scheme == "int16"
                        else torch.bfloat16)
    np.testing.assert_array_equal(_bits(ts), _bits(rs))
    back = tquant.dequantize_array(ts, scheme, tscale)
    np.testing.assert_array_equal(
        _bits(back), _bits(rquant.dequantize_array(rs, scheme, rscale)))
    assert float(np.abs(back.numpy() - vals).max()) <= bound
    assert np.all(back.numpy()[vals == 0.0] == 0.0)


def test_int16_all_zero_row_uses_unit_scale():
    stored, scale = tquant.quantize_array(np.zeros((4, 7), np.float32),
                                          "int16", 1e-9)
    assert scale == 1.0
    assert stored.dtype == torch.int16 and not stored.any()


@pytest.mark.parametrize("scheme, vals, bound, ok, match", [
    ("int16", [1.0, 0.5, 0.0], 1.0 / (4 * 32767), False, "int16 step"),
    ("int16", [1.0, 0.5, 0.0], 0.5 / 32767 * (1 + 2.0 ** -6) * (1 + 1e-9),
     True, None),
    ("bf16", [0.999, 0.25], 2.0 ** -9, False, "bf16"),
    ("bf16", [0.999, 0.25], 2.0 ** -7, True, None),
    ("int8", [0.0], 1.0, False, "unknown quantization scheme")])
def test_quantize_array_refusals_match_reference(scheme, vals, bound, ok,
                                                 match):
    """The a priori certificates refuse on exactly the reference's
    inputs, and succeed just past the threshold."""
    vals = np.float32(vals)
    for quantize_array in (rquant.quantize_array, tquant.quantize_array):
        if ok:
            quantize_array(vals, scheme, bound)
        else:
            with pytest.raises(ValueError, match=match):
                quantize_array(vals, scheme, bound)


def test_quantinfo_meta_roundtrip_refuses_unknown_fields():
    info = tquant.QuantInfo(scheme="int16", scale=0.5, bound=1e-3,
                            d_scale=0.25, d_bound=1e-4)
    assert tquant.QuantInfo.from_meta(info.to_meta()) == info
    assert info.to_meta() == rquant.QuantInfo(**info.to_meta()).to_meta()
    with pytest.raises(ValueError, match="unknown quantization metadata"):
        tquant.QuantInfo.from_meta(dict(info.to_meta(), dither="tpdf"))


# ----------------------------------------------------------------------
# quantize_index
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scheme, quantize_d", [("int16", True),
                                                ("int16", False),
                                                ("bf16", False)])
def test_quantize_index_matches_reference_and_is_certified(
        qgraph, tmp_path, scheme, quantize_d):
    eps, frac = (0.1, 0.25) if scheme == "int16" else (0.2, 0.8)
    ri = rbuild.build_index(qgraph, eps=eps, exact_d=True, seed=0,
                            quant_frac=frac)
    ti = _carry(ri, tmp_path)
    rq = rquant.quantize_index(ri, scheme, quantize_d=quantize_d)
    tq = tquant.quantize_index(ti, scheme, quantize_d=quantize_d)
    assert tq.quant == tquant.QuantInfo(**rq.quant.to_meta())
    np.testing.assert_array_equal(_bits(tq.hp.vals), _bits(rq.hp.vals))
    np.testing.assert_array_equal(_bits(tq.d), _bits(rq.d))
    fp = ti.hp.vals.numpy()
    assert np.abs(tq.vals_f32().numpy() - fp).max() <= tq.quant.bound
    assert np.abs(tq.d.numpy() - ti.d.numpy()).max() <= \
        (tq.quant.d_bound if quantize_d else 0.0)
    assert np.all(tq.vals_f32().numpy()[fp == 0.0] == 0.0)
    # keys and counts are shared; the source index is untouched
    assert tq.hp.keys is ti.hp.keys and tq.hp.counts is ti.hp.counts
    assert ti.hp.vals.dtype == torch.float32 and ti.quant is None
    hp = tq.dequantized_hp()
    assert hp.keys is tq.hp.keys and hp.counts is tq.hp.counts
    np.testing.assert_array_equal(_bits(hp.vals), _bits(rq.vals_f32()))
    assert ti.dequantized_hp() is ti.hp
    if not quantize_d:
        assert tq.quant.d_scale == 0.0
        # the vals-only bound is the whole reserve, looser than a split
        assert tq.quant.bound > ttheory.quant_vals_bound(ti.plan, True)


def test_bf16_refused_where_the_reference_refuses(qindex, tmp_path):
    """At eps = 0.1 vmax = 1 gives 2^-8 > the bound: both refuse."""
    ti = _carry(qindex, tmp_path)
    for quantize_index, idx in ((rquant.quantize_index, qindex),
                                (tquant.quantize_index, ti)):
        with pytest.raises(ValueError, match="bf16 relative step"):
            quantize_index(idx, "bf16", quantize_d=False)


def test_quantize_index_refusals(qgraph, qindex, tmp_path):
    tg = _tgraph(qgraph)
    ti = _carry(qindex, tmp_path)
    iq = tquant.quantize_index(ti)
    with pytest.raises(ValueError, match="already quantized"):
        tquant.quantize_index(iq)
    plain = tbuild.build_index(tg, eps=0.1, exact_d=True, device="cpu")
    with pytest.raises(ValueError, match="eps_quant_frac"):
        tquant.quantize_index(plain)
    red = _carry(qindex, tmp_path, "red.sling")
    topt.mark_for_enhancement(red, tg)
    with pytest.raises(ValueError, match="space-reduction"):
        tquant.quantize_index(red)
    with pytest.raises(ValueError, match="space-reduce a quantized"):
        topt.apply_space_reduction(iq, tg)
    # the enhancement reads float32 values: a quantized index is refused
    with pytest.raises(ValueError, match="quantized index"):
        topt.mark_for_enhancement(iq, tg)


def test_quantized_swap_adds_no_shape(qgraph, qindex, tmp_path):
    tg = _tgraph(qgraph)
    ti = _carry(qindex, tmp_path)
    eng = QueryEngine(ti, tg, EngineConfig(pair_batch=8, source_batch=4),
                      device="cpu")
    eng.warmup()
    before = set(eng.stats()["unique_shapes"])
    us = np.arange(5, dtype=np.int32)
    ref = eng.single_source(us)
    pref = eng.pairs(us, us[::-1])
    iq = tquant.quantize_index(ti)
    out = eng.swap_index(iq, tg)
    assert out["recompiles"] == 0
    got = eng.single_source(us)
    st = eng.stats()
    assert set(st["unique_shapes"]) == before
    assert st["swap_recompiles"] == 0 and st["quantized"] == "int16"
    tol = ttheory.quant_charge(ti.plan, iq.quant.bound, iq.quant.d_bound)
    assert np.abs(got - ref).max() <= tol
    assert np.abs(eng.pairs(us, us[::-1]) - pref).max() <= tol


# ----------------------------------------------------------------------
# Section 5 (optimizations) against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ZOO)
def test_eta_and_exact_step12_match_reference(name):
    g = oracle.cases()[name]
    tg = _tgraph(g)
    np.testing.assert_array_equal(topt.eta(tg), ropt.eta(g))
    sc = 0.6 ** 0.5
    for v in range(g.n):
        tk, tv = topt.exact_step12(tg, v, sc)
        rk, rv = ropt.exact_step12(g, v, sc)
        np.testing.assert_array_equal(tk, rk)
        np.testing.assert_array_equal(tv, rv)


@pytest.mark.parametrize("name", ZOO)
def test_space_reduction_and_marks_match_reference(name, tmp_path):
    g = oracle.cases()[name]
    tg = _tgraph(g)
    ri = rbuild.build_index(g, eps=0.1, exact_d=True)
    ti = _carry(ri, tmp_path)
    saved_r = ropt.apply_space_reduction(ri, g)
    saved_t = topt.apply_space_reduction(ti, tg)
    assert saved_t == saved_r
    np.testing.assert_array_equal(ti.reduced, ri.reduced)
    np.testing.assert_array_equal(ti.hp.counts.numpy(), ri.hp.counts)
    np.testing.assert_array_equal(ti.hp.keys.numpy(), ri.hp.keys)
    np.testing.assert_array_equal(_bits(ti.hp.vals), _bits(ri.hp.vals))
    ropt.mark_for_enhancement(ri, g)
    topt.mark_for_enhancement(ti, tg)
    np.testing.assert_array_equal(ti.marks, ri.marks)


@pytest.mark.parametrize("name", ZOO)
def test_build_index_section5_and_quant_match_reference(name):
    g = oracle.cases()[name]
    kw = dict(eps=0.1, exact_d=True, space_reduce=True, enhance=True,
              quant_frac=0.25)
    ri = rbuild.build_index(g, **kw)
    ti = tbuild.build_index(_tgraph(g), device="cpu", **kw)
    assert dataclasses.asdict(ti.plan) == dataclasses.asdict(ri.plan)
    np.testing.assert_array_equal(ti.reduced, ri.reduced)
    np.testing.assert_array_equal(ti.hp.keys.numpy(), ri.hp.keys)
    np.testing.assert_array_equal(ti.hp.counts.numpy(), ri.hp.counts)
    np.testing.assert_allclose(ti.hp.vals.numpy(), ri.hp.vals, atol=ATOL,
                               rtol=0)
    # the marks pick each row's largest values: equal where the two
    # builds' values are equal bit for bit, else the marked values agree
    tv = np.take_along_axis(ti.hp.vals.numpy(), np.maximum(ti.marks, 0), 1)
    rv = np.take_along_axis(ri.hp.vals, np.maximum(ri.marks, 0), 1)
    np.testing.assert_array_equal(ti.marks >= 0, ri.marks >= 0)
    np.testing.assert_allclose(np.where(ti.marks >= 0, tv, 0),
                               np.where(ri.marks >= 0, rv, 0), atol=ATOL,
                               rtol=0)
    if np.array_equal(_bits(ti.hp.vals), _bits(ri.hp.vals)):
        np.testing.assert_array_equal(ti.marks, ri.marks)


@pytest.mark.parametrize("name", ZOO)
def test_host_single_source_reduced_enhanced_matches_reference(
        name, tmp_path):
    """Host single-source reads H(u) through ``_host_entries``: reduced
    rows re-materialized and enhanced as the reference does."""
    g = oracle.cases()[name]
    tg = _tgraph(g)
    ri = rbuild.build_index(g, eps=0.1, exact_d=True, space_reduce=True,
                            enhance=True)
    p = str(tmp_path / "s.sling")
    ri.save(p)
    ti = TIndex.load(p, mmap=True)
    assert ri.reduced.any()
    for u in range(0, g.n, 5):
        for tfn, rfn in ((tss.single_source_paper, rss.single_source_paper),
                         (tss.single_source_horner,
                          rss.single_source_horner)):
            np.testing.assert_allclose(tfn(ti, tg, u),
                                       np.asarray(rfn(ri, g, u)),
                                       atol=ATOL, rtol=0)
    r = RIndex.load(p)
    assert ti.query_pair_host(1, 2, tg) == pytest.approx(
        r.query_pair_host(1, 2, g), abs=ATOL)
