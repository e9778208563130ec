"""``spmm`` with a prune threshold and live-segment masks, on the CPU.

The prune-on-read form ``spmm(x, layout, tau=..., live=..., live_out=...)``
is held against the JAX reference (the Pallas ``spmm_block`` in
interpret mode and ``spmm_ref``) applied to the pruned x;
``segment_live`` against a NumPy count; the wrapper's refusals; and the
build and the mass scans, which now chain the masks, against a replay
of the dense loop they replaced (bit for bit) and against the
reference. The kernel itself is held against these on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from repro.core import hp_index as rhp
from repro.core import theory as rtheory
from repro.graph import csr as rcsr
from repro.graph import generators as rgen
from repro.kernels.spmv_ell import ops as rspmm
from repro.kernels.spmv_ell.ref import spmm_ref
from repro_torch import convert
from repro_torch.core import hp_index as thp
from repro_torch.kernels.spmv_ell import (SpmmLayout, mask_words,
                                          segment_live, spmm, spmm_plain)

ATOL = oracle.BACKEND_ATOL
TAU = 0.45
ZOO = tuple(oracle.cases())


def _graph(kind):
    """The graphs of the spmm tests in tests/test_torch_kernels.py: a
    power-law graph with hubs, one with in-degree-0 rows, a multigraph."""
    r = {"hubs": lambda: rgen.barabasi_albert(100, 5, seed=105,
                                              directed=True),
         "sinks": lambda: rgen.with_sinks(40, 120, n_sinks=5, seed=7),
         "multigraph": lambda: rgen.multigraph(32, 90, seed=9)}[kind]()
    return r, convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)


def _frontier(rng, n, f):
    """A non-negative slab like a pruned frontier: most segments empty,
    some entries exactly at TAU (pruned: the test is strict)."""
    x = rng.random((n, f)).astype(np.float32)
    x *= rng.random((n, f)) < 0.3
    x[rng.random((n, f)) < 0.05] = np.float32(TAU)
    x[rng.random(n) < 0.5] = 0.0
    return x


@pytest.mark.parametrize("f", [1, 3, 32, 33, 256, 257])
@pytest.mark.parametrize("layout", ["pull", "push"])
@pytest.mark.parametrize("kind", ["hubs", "sinks", "multigraph"])
def test_spmm_with_tau_matches_reference(kind, layout, f):
    """Â prune_tau(x), with and without the live mask, against the
    reference kernel and spmm_ref on the pruned x; live_out is the mask
    of the result."""
    r, t = _graph(kind)
    sc = 0.7746
    w = rcsr.normalized_pull_weights(r, sc)
    x = _frontier(np.random.default_rng(f), r.n, f)
    xp = np.where(x > np.float32(TAU), x, 0.0).astype(np.float32)
    if layout == "pull":
        rg, rw, src, dst = r, w, r.edge_src, r.edge_dst
    else:
        rg = rcsr.from_edges(r.n, r.edge_dst, r.edge_src, dedup=False)
        rw = w[np.argsort(r.edge_src, kind="stable")]
        src, dst = r.edge_dst, r.edge_src
    ref_k = np.asarray(rspmm.spmm(xp, rg, rw, bn=8, eb=16))
    seg = np.asarray(spmm_ref(jnp.asarray(xp), jnp.asarray(src),
                              jnp.asarray(dst), jnp.asarray(w), r.n))
    lay = getattr(SpmmLayout, layout)(t, sc, "cpu")
    xt = torch.as_tensor(x)
    bare = spmm(xt, lay, tau=TAU)
    live_out = torch.empty((r.n, mask_words(f)), dtype=torch.int32)
    masked = spmm(xt, lay, tau=TAU, live=segment_live(xt, TAU),
                  live_out=live_out)
    np.testing.assert_allclose(masked.numpy(), ref_k, atol=ATOL, rtol=0)
    np.testing.assert_allclose(masked.numpy(), seg, atol=ATOL, rtol=0)
    assert torch.equal(bare, masked)
    assert torch.equal(masked, spmm(torch.as_tensor(xp), lay))
    assert torch.equal(live_out, segment_live(masked, TAU))


def _numpy_mask(x, tau):
    n, f = x.shape
    words = -(-f // 1024)
    out = np.zeros((n, words), np.uint32)
    for s in range(-(-f // 32)):
        hot = (x[:, 32 * s:32 * s + 32] > tau).any(axis=1)
        out[:, s // 32] |= hot.astype(np.uint32) << np.uint32(s % 32)
    return out


@pytest.mark.parametrize("f", [1, 31, 32, 33, 256, 1024, 1025, 2100])
def test_segment_live_matches_numpy_count(f):
    rng = np.random.default_rng(f)
    x = _frontier(rng, 23, f)
    x[3, f - 1] = 1.0                 # the last segment of the last word
    if f > 992:
        x[5, 31 * 32] = 1.0           # bit 31, the int32 sign bit
    got = segment_live(torch.as_tensor(x), TAU)
    assert got.dtype == torch.int32 and got.shape == (23, mask_words(f))
    want = _numpy_mask(x, np.float32(TAU))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the popcount is the number of live segments
    live = sum(int((x[:, 32 * s:32 * s + 32] > TAU).any(axis=1).sum())
               for s in range(-(-f // 32)))
    assert sum(bin(int(v)).count("1") for v in want.ravel()) == live


def _refusal_case():
    lay = SpmmLayout.from_edges([0, 1, 2], [2, 3, 3], [0.5, 0.5, 0.5], 6,
                                "cpu")
    x = torch.zeros((6, 40))
    good = torch.zeros((6, 1), dtype=torch.int32)
    return lay, x, good


REFUSALS = {
    "live-without-tau": (ValueError, lambda lay, x, m: spmm(x, lay, live=m)),
    "live_out-without-tau": (ValueError,
                             lambda lay, x, m: spmm(x, lay, live_out=m)),
    "plain-live_out-without-tau": (
        ValueError, lambda lay, x, m: spmm_plain(x, lay, live_out=m)),
    "live-shape": (ValueError, lambda lay, x, m: spmm(
        x, lay, tau=0.1, live=torch.zeros((6, 2), dtype=torch.int32))),
    "live_out-rows": (ValueError, lambda lay, x, m: spmm(
        x, lay, tau=0.1, live_out=torch.zeros((5, 1), dtype=torch.int32))),
    "live-dtype": (TypeError, lambda lay, x, m: spmm(
        x, lay, tau=0.1, live=m.long())),
    "live_out-dtype": (TypeError, lambda lay, x, m: spmm(
        x, lay, tau=0.1, live_out=m.float())),
    "live-device": (ValueError, lambda lay, x, m: spmm(
        x, lay, tau=0.1, live=torch.zeros((6, 1), dtype=torch.int32,
                                          device="meta"))),
    "live-strided": (ValueError, lambda lay, x, m: spmm(
        torch.zeros((6, 1100)), lay, tau=0.1,
        live=torch.zeros((2, 6), dtype=torch.int32).t())),
    "live-is-live_out": (ValueError, lambda lay, x, m: spmm(
        x, lay, tau=0.1, live=m, live_out=m)),
    "out-is-x": (ValueError, lambda lay, x, m: spmm(x, lay, out=x)),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_spmm_refuses_bad_masks(case):
    err, call = REFUSALS[case]
    with pytest.raises(err):
        call(*_refusal_case())


def _layout_fields():
    lay = SpmmLayout.from_edges([0, 1, 2], [2, 3, 3], [0.5, 0.5, 0.5], 6,
                                "cpu")
    return {f: getattr(lay, f) for f in
            ("n", "in_ptr", "in_idx", "w", "heavy", "light")}


I32 = torch.int32
LAYOUT_REFUSALS = {
    "in_ptr-length": (ValueError, dict(in_ptr=torch.zeros(6, dtype=I32))),
    "w-length": (ValueError, dict(w=torch.zeros(2))),
    "rows-not-split": (ValueError, dict(light=torch.zeros(3, dtype=I32))),
    "w-dtype": (TypeError, dict(w=torch.zeros(3, dtype=torch.float64))),
    "idx-dtype": (TypeError, dict(in_idx=torch.zeros(3, dtype=torch.int64))),
    "device": (ValueError, dict(w=torch.zeros(3, device="meta"))),
    "strided": (ValueError, dict(in_idx=torch.zeros((3, 2), dtype=I32)[:, 0])),
}


@pytest.mark.parametrize("case", LAYOUT_REFUSALS)
def test_spmm_layout_refuses_bad_arrays(case):
    """The layout checks its arrays once, when it is made; the wrappers
    then check only their own arguments against it."""
    err, bad = LAYOUT_REFUSALS[case]
    with pytest.raises(err):
        SpmmLayout(**{**_layout_fields(), **bad})


def test_spmm_mask_of_a_column_alone_is_bit_exact():
    """A column propagated alone (its own masks) equals the same column
    inside the block, over three chained steps."""
    r, t = _graph("hubs")
    lay = SpmmLayout.pull(t, 0.77, "cpu")
    tau = 0.02
    x = torch.as_tensor(_frontier(np.random.default_rng(4), r.n, 40))
    wide, cols = x, {j: x[:, j:j + 1].contiguous() for j in (0, 31, 32, 39)}
    live_w = segment_live(wide, tau)
    live_c = {j: segment_live(c, tau) for j, c in cols.items()}
    for _ in range(3):
        out = torch.empty_like(live_w)
        wide = spmm(wide, lay, tau=tau, live=live_w, live_out=out)
        live_w = out
        assert bool(live_w.any())
        for j in cols:
            out = torch.empty_like(live_c[j])
            cols[j] = spmm(cols[j], lay, tau=tau, live=live_c[j],
                           live_out=out)
            live_c[j] = out
            assert torch.equal(cols[j][:, 0], wide[:, j])


def _dense_build(t, theta, sqrt_c, l_max, block):
    """The build loop before the masks: prune, spmm_plain of the pruned
    frontier, stop when no entry exceeds theta."""
    n = t.n
    lay = SpmmLayout.pull(t, sqrt_c, "cpu")
    theta = float(np.float32(theta))
    src, key, val = [], [], []
    for b0 in range(0, n, block):
        tid = torch.arange(b0, min(b0 + block, n))
        h = torch.zeros((n, block))
        h[tid, tid - b0] = 1.0
        for l in range(l_max + 1):
            hp = torch.where(h > theta, h, 0.0)
            kept = hp[:, :len(tid)]
            i, b = torch.nonzero(kept, as_tuple=True)
            src.append(i)
            key.append(l * n + tid[b])
            val.append(kept[i, b])
            if l == l_max:
                break
            h = spmm_plain(hp, lay)
            if not bool((h > theta).any()):
                break
    return torch.cat(src), torch.cat(key), torch.cat(val)


@pytest.mark.parametrize("name", ZOO)
def test_build_hp_table_equals_the_dense_loop(name):
    """The masked build keeps exactly the entries of the dense loop (and
    the stop test stops at the same step), and agrees with the
    reference."""
    r = oracle.cases()[name]
    t = convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)
    p = rtheory.plan(eps=0.05, c=0.6, n=r.n)
    got = thp.build_hp_table(t, p.theta, p.sqrt_c, p.l_max, block=16,
                             device="cpu")
    src, key, val = _dense_build(t, p.theta, p.sqrt_c, p.l_max, 16)
    want = thp._pack_coo(src.to(torch.int32), key.to(torch.int32), val,
                         t.n, p.theta, p.sqrt_c, p.l_max)
    assert got.width == want.width
    assert torch.equal(got.keys, want.keys)
    assert torch.equal(got.vals, want.vals)
    # against the reference as tests/test_torch_build.py holds it: keys
    # equal, values to ATOL, an entry on one side only within float32
    # rounding of theta
    ref = rhp.build_hp_table(r, p.theta, p.sqrt_c, p.l_max, block=16)
    e_ref = _entries(ref.keys, ref.vals)
    e_got = _entries(got.keys.numpy(), got.vals.numpy())
    only = [v for k, v in e_ref.items() if k not in e_got] + \
        [v for k, v in e_got.items() if k not in e_ref]
    assert all(abs(v - p.theta) <= 4e-7 * p.theta for v in only), only
    shared = [k for k in e_ref if k in e_got]
    np.testing.assert_allclose([e_got[k] for k in shared],
                               [e_ref[k] for k in shared], atol=ATOL, rtol=0)


def _entries(keys, vals):
    """{(row, key): value} of a packed table."""
    rows, cols = np.nonzero(keys != rhp.INT32_PAD_KEY)
    return dict(zip(zip(rows.tolist(), keys[rows, cols].tolist()),
                    vals[rows, cols].tolist()))


def _dense_mass(t, seeds, sqrt_c, theta, l_max, transpose, weights):
    lay = (SpmmLayout.push if transpose else SpmmLayout.pull)(t, sqrt_c,
                                                               "cpu")
    theta = float(np.float32(theta))
    h = thp._one_hot_block(t.n, seeds, 256, "cpu", weights=weights)
    acc, skip = torch.zeros_like(h), torch.zeros_like(h)
    for l in range(l_max + 1):
        hp = torch.where(h > theta, h, 0.0)
        acc += hp
        skip += h - hp
        if l < l_max:
            h = spmm_plain(hp, lay)
    return (acc.max(dim=1).values.double().numpy(),
            acc.double().sum(dim=1).numpy(), skip.double().sum(dim=1).numpy())


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ZOO)
def test_propagation_mass_equals_the_dense_loop(name, transpose):
    r = oracle.cases()[name]
    t = convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)
    p = rtheory.plan(eps=0.05, c=0.6, n=r.n)
    rng = np.random.default_rng(len(name))
    seeds = rng.choice(r.n, 12, replace=False)
    wts = (1.0 - rng.random(12)).astype(np.float32)
    got = thp.propagation_mass(t, seeds, p.sqrt_c, p.theta, p.l_max,
                               transpose=transpose, weights=wts,
                               device="cpu")
    want = _dense_mass(t, seeds, p.sqrt_c, p.theta, p.l_max, transpose, wts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ref = rhp.propagation_mass(r, seeds, p.sqrt_c, p.theta, p.l_max,
                               transpose=transpose, weights=wts)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
