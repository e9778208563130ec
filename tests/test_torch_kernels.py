"""The port's Hopper kernels' plain versions held against the JAX
reference kernels (Pallas interpret mode) and their references, on the
CPU; and the wrappers' argument contracts.

On the CPU the wrappers (``hp_join``, ``horner_push_rows``, ``spmm``) take
the plain versions because the tensors lie on the CPU. The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import oracle
import pytest
import torch

from repro.core.hp_index import INT32_PAD_KEY
from repro.core import build as rbuild
from repro.core import single_source as rss
from repro.core.single_source import horner_push as rhorner_push
from repro.graph import csr as rcsr
from repro.graph import generators as rgen
from repro.kernels.horner_push import ops as rhp_ops
from repro.kernels.horner_push import ref as rhp_ref
from repro.kernels.hp_join.hp_join import hp_join as rhp_join
from repro.kernels.hp_join.ref import join_ref
from repro.kernels.spmv_ell import ops as rspmm
from repro.kernels.spmv_ell.ref import spmm_ref
from repro_torch import convert
from repro_torch.core import device_state as tdevice_state
from repro_torch.core import single_source as tss
from repro_torch.graph import generators as tgen
from repro_torch.kernels.horner_push import (horner_push_rows,
                                             horner_step_plain,
                                             level_runs_plain,
                                             resolve_push_backend,
                                             workspace_numel)
from repro_torch.kernels.hp_join import hp_join, hp_join_plain
from repro_torch.kernels.spmv_ell import (HEAVY_DEGREE, PUSH_TIERS,
                                          SpmmLayout, spmm, spmm_plain)
from torch_cases import JOIN_CASES, join_rows, port_join, port_push, \
    rand_case, table_case

ATOL = 1e-5


# ----------------------------------------------------------------------
# hp_join
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", JOIN_CASES)
def test_hp_join_plain_matches_reference_kernel(case):
    rng = np.random.default_rng(sorted(JOIN_CASES).index(case))
    ku, vu, kv, vv = join_rows(rng, **JOIN_CASES[case])
    ref = np.asarray(rhp_join(*map(jnp.asarray, (ku, vu, kv, vv)),
                              bq=8, interpret=True))
    got = port_join(ku, vu, kv, vv)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if case == "pad-rows":
        assert np.all(got[[0, 3, 7]] == 0.0)


@pytest.mark.parametrize("K", [64, 128])
def test_hp_join_plain_matches_join_ref_without_duplicates(K):
    rng = np.random.default_rng(K)
    ku, vu, kv, vv = join_rows(rng, 16, K, key_range=2 * K)
    ref = np.asarray(join_ref(*map(jnp.asarray, (ku, vu, kv, vv))))
    np.testing.assert_allclose(port_join(ku, vu, kv, vv), ref, atol=ATOL,
                               rtol=0)


def test_hp_join_wrapper_rejects_bad_arguments():
    keys = torch.zeros((4, 64), dtype=torch.int32)
    vals = torch.zeros((4, 64))
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        hp_join(keys, vals, ids.long(), ids)
    with pytest.raises(ValueError):
        hp_join(keys, vals[:, :32], ids, ids)
    with pytest.raises(ValueError):
        hp_join(keys.t(), vals.t(), ids, ids)   # not contiguous
    assert hp_join_plain(keys, vals, ids, ids).shape == (2,)


# ----------------------------------------------------------------------
# horner_push
# ----------------------------------------------------------------------
def _check_push(case, *, n, l_max, bn=8, eb=16):
    """Port plain push vs the reference Pallas kernel (interpret), its
    float64 blocked mirror, and the lax push; also the CPU wrapper."""
    got = port_push(case, n, l_max)
    bs, bdl, bw = rhp_ops.block_align_edges(case["src"], case["dst"],
                                            case["w"], n, bn=bn, eb=eb)
    pallas = np.asarray(rhp_ops.horner_push_pallas(
        *map(jnp.asarray, (case["ku"], case["xu"], case["d"], bs, bdl, bw)),
        jnp.float32(case["tau"]), n=n, l_max=l_max, bn=bn, eb=eb, bq=8,
        interpret=True))
    blocked = rhp_ref.horner_push_blocked_ref(
        case["ku"], case["xu"], case["d"], bs, bdl, bw, case["tau"],
        n=n, l_max=l_max, bn=bn)
    lax = np.asarray(rhorner_push(
        *map(jnp.asarray, (case["ku"], case["xu"], case["d"], case["src"],
                           case["dst"], case["w"])),
        jnp.float32(case["tau"]), n=n, l_max=l_max))
    assert got.shape == pallas.shape == blocked.shape == lax.shape
    for ref in (pallas, blocked, lax):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # the wrapper on CPU tensors, reading the rows by id, is the plain push
    lay = SpmmLayout.from_edges(case["src"], case["dst"], case["w"], n,
                                "cpu")
    B = case["ku"].shape[0]
    rows = horner_push_rows(
        *map(torch.as_tensor, (case["ku"], case["xu"], case["d"])),
        torch.arange(B), lay, float(case["tau"]), l_max=l_max)
    np.testing.assert_array_equal(rows.numpy(), got)
    return got


def test_push_batch_of_one():
    rng = np.random.default_rng(0)
    _check_push(rand_case(rng, n=17, B=1, W=4, l_max=3, m=40), n=17,
                l_max=3)


def test_push_ragged_batch():
    rng = np.random.default_rng(1)
    _check_push(rand_case(rng, n=23, B=9, W=3, l_max=2, m=60), n=23,
                l_max=2)


def test_push_n_not_multiple_of_node_block():
    rng = np.random.default_rng(2)
    got = _check_push(rand_case(rng, n=13, B=4, W=4, l_max=3, m=30), n=13,
                      l_max=3, bn=8, eb=8)
    assert got.shape == (4, 13)


def test_push_empty_frontier_after_prune():
    """tau above every score: only the level-0 seed survives."""
    rng = np.random.default_rng(3)
    case = rand_case(rng, n=11, B=3, W=4, l_max=4, m=40, tau=1e9)
    got = _check_push(case, n=11, l_max=4, eb=8)
    seed0 = np.zeros((3, 11))
    ls = np.where(case["ku"] == INT32_PAD_KEY, -1, case["ku"] // 11)
    ks = np.clip(case["ku"] % 11, 0, 10)
    for b in range(3):
        np.add.at(seed0[b], ks[b],
                  np.where(ls[b] == 0, case["xu"][b] * case["d"][ks[b]], 0))
    np.testing.assert_allclose(got, seed0, atol=ATOL, rtol=0)


def test_push_all_pad_rows():
    rng = np.random.default_rng(4)
    case = rand_case(rng, n=19, B=5, W=4, l_max=3, m=50)
    case["ku"][:] = INT32_PAD_KEY
    assert np.all(_check_push(case, n=19, l_max=3, eb=8) == 0.0)


def test_push_duplicate_keys_accumulate():
    n, k_tgt = 9, 5
    case = dict(src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                w=np.zeros(0, np.float32),
                ku=np.full((1, 2), k_tgt, np.int32),
                xu=np.float32([[0.25, 0.125]]),
                d=np.linspace(0.5, 1.0, n).astype(np.float32),
                tau=np.float32(0.0))
    got = _check_push(case, n=n, l_max=0, bn=4, eb=8)
    assert got[0, k_tgt] == pytest.approx(0.375 * float(case["d"][k_tgt]),
                                          abs=1e-6)


def test_push_tau_zero():
    rng = np.random.default_rng(5)
    _check_push(rand_case(rng, n=21, B=4, W=5, l_max=3, m=70, tau=0.0),
                n=21, l_max=3)


def test_plain_push_is_single_source_horner_push():
    rng = np.random.default_rng(6)
    case = rand_case(rng, n=30, B=8, W=6, l_max=5, m=120)
    lay = SpmmLayout.from_edges(case["src"], case["dst"], case["w"], 30,
                                "cpu")
    got = tss.horner_push(torch.as_tensor(case["ku"]),
                          torch.as_tensor(case["xu"]),
                          torch.as_tensor(case["d"]), lay,
                          float(case["tau"]), n=30, l_max=5)
    np.testing.assert_array_equal(got.numpy(), port_push(case, 30, 5))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("name", ["powerlaw", "multigraph"])
def test_push_rows_on_an_index_table_match_reference(name, B):
    """The id-driven push on an index's own packed table (rows sorted,
    PAD last), on the CPU, against the reference's batched push
    (``repro.core.single_source.single_source_device``) on the same
    index bytes, within BACKEND_ATOL; the kernel and plain backends are
    one path here."""
    g = oracle.cases()[name]
    ri = rbuild.build_index(g, eps=0.1, exact_d=True)
    tg = convert.graph_from_arrays(g.n, g.edge_src, g.edge_dst)
    ti = convert.index_from_arrays(
        {f: getattr(ri.plan, f) for f in ri.plan.__dataclass_fields__},
        ri.d, ri.hp.keys, ri.vals_f32(), ri.hp.counts, builder=ri.builder,
        device="cpu")
    us = np.random.default_rng(B).integers(0, g.n, B)
    want = np.asarray(rss.single_source_device(ri, g, us))
    st = tdevice_state.serving_arrays(ti, tg, "cpu")
    for backend in ("kernel", "plain"):
        got = tss.batched_single_source(
            st.keys, st.vals, st.d, st.layout, torch.as_tensor(us), st.tau,
            n=g.n, l_max=ti.plan.l_max, backend=backend)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=oracle.BACKEND_ATOL, rtol=0)


def test_push_layout_groups_edges_by_destination():
    rng = np.random.default_rng(7)
    n, m = 25, 90
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32)
    lay = SpmmLayout.from_edges(src, dst, w, n, "cpu")
    ptr = lay.in_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == m and np.all(np.diff(ptr) >= 0)
    for v in range(n):
        sel = np.flatnonzero(dst == v)   # input order kept within a row
        np.testing.assert_array_equal(lay.in_idx.numpy()[ptr[v]:ptr[v + 1]],
                                      src[sel])
        np.testing.assert_array_equal(lay.w.numpy()[ptr[v]:ptr[v + 1]],
                                      w[sel])


def test_horner_steps_wrapper_rejects_bad_arguments():
    """The push wrapper (``horner_push_rows``) checks its arguments
    against the layout before it takes any path."""
    n, N, W, l_max = 6, 4, 3, 2
    lay = SpmmLayout.from_edges([0, 1], [2, 3], [0.5, 0.5], n, "cpu")
    keys = torch.zeros((N, W), dtype=torch.int32)
    vals, d = torch.zeros((N, W)), torch.ones(n)
    us = torch.tensor([0, 2])

    def push(keys=keys, vals=vals, d=d, us=us, lay=lay, **kw):
        return horner_push_rows(keys, vals, d, us, lay, 0.0, l_max=l_max,
                                **kw)

    with pytest.raises(ValueError):
        push(vals=torch.zeros((N, W + 1)))
    with pytest.raises(ValueError):   # a layout of another graph size
        push(lay=SpmmLayout.from_edges([0], [1], [0.5], n + 1, "cpu"))
    with pytest.raises(ValueError):
        push(us=us.view(2, 1))
    with pytest.raises(TypeError):
        push(vals=vals.double())
    with pytest.raises(TypeError):
        push(us=us.float())
    with pytest.raises(ValueError):
        push(keys=torch.zeros((W, N), dtype=torch.int32).t())
    with pytest.raises(ValueError):
        push(workspace=torch.empty(workspace_numel(n, 2, l_max) - 1))
    ws = torch.empty(workspace_numel(n, 2, l_max))
    assert push(workspace=ws).shape == (2, n)
    assert push(us=us.int()).shape == (2, n)


LEVEL_RUN_CASES = {
    "ragged": dict(n=11, rows=6, W=9, l_max=4, pad_frac=0.3),
    "pad-rows": dict(n=7, rows=5, W=6, l_max=3, pad_frac=0.3, pad=(0, 3)),
    "full-rows": dict(n=13, rows=4, W=8, l_max=2, pad_frac=0.0),
    "empty-levels": dict(n=9, rows=5, W=7, l_max=6, pad_frac=0.2,
                         levels=(0, 3)),
    "duplicates": dict(n=5, rows=6, W=10, l_max=3, pad_frac=0.2, dup=True),
}


def _level_rows(rng, *, n, rows, W, l_max, pad_frac, pad=(), levels=None,
                dup=False):
    """Sorted key rows with PAD last; ``levels`` keeps only those levels
    (so the others are empty), ``pad`` makes those rows all PAD."""
    lv = rng.integers(0, l_max + 1, (rows, W)) if levels is None else \
        rng.choice(levels, (rows, W))
    keys = (lv * n + rng.integers(0, 2 if dup else n, (rows, W))
            ).astype(np.int32)
    keys[rng.random((rows, W)) < pad_frac] = INT32_PAD_KEY
    keys[list(pad)] = INT32_PAD_KEY
    return np.sort(keys, axis=1)


@pytest.mark.parametrize("case", LEVEL_RUN_CASES)
def test_level_runs_match_a_numpy_count(case):
    """``level_runs_plain`` -- what the kernel's prologue finds -- against
    a plain count: level l's run of row b starts after the entries of
    levels < l, and a row's last level is that of its last live entry
    (-1 for an all-PAD row)."""
    spec = LEVEL_RUN_CASES[case]
    rng = np.random.default_rng(sorted(LEVEL_RUN_CASES).index(case))
    keys = _level_rows(rng, **spec)
    n, l_max = spec["n"], spec["l_max"]
    runs, last = level_runs_plain(torch.as_tensor(keys), n, l_max)
    live = keys != INT32_PAD_KEY
    lv = np.where(live, keys // n, l_max + 1)
    want = np.stack([(lv < level).sum(axis=1)
                     for level in range(l_max + 2)], axis=1)
    np.testing.assert_array_equal(runs.numpy(), want)
    top = np.array([lv[b][live[b]].max() if live[b].any() else -1
                    for b in range(len(keys))])
    np.testing.assert_array_equal(last.numpy(), top)
    for b in range(len(keys)):   # each run holds exactly its level's keys
        for level in range(l_max + 1):
            run = keys[b, want[b, level]:want[b, level + 1]]
            assert np.all(run // n == level)
    if "pad" in spec:
        assert np.all(last.numpy()[list(spec["pad"])] == -1)


@pytest.mark.parametrize("seed", range(3))
def test_plain_push_is_zero_above_the_top_seed_level(seed):
    """Above the highest level that holds a seed, the plain push from a
    zero frontier is exactly zero, level by level; so starting there,
    as the kernel does, gives the push's bits."""
    rng = np.random.default_rng(seed)
    n, l_max = 24, 7
    case = table_case(rng, n=n, rows=4, W=6, l_max=3, m=90, hubs=(1,))
    lay = SpmmLayout.from_edges(case["src"], case["dst"], case["w"], n,
                                "cpu")
    keys = torch.as_tensor(case["ku"])
    contrib = torch.where(keys == INT32_PAD_KEY, 0.0,
                          torch.as_tensor(case["xu"]) * torch.as_tensor(
                              case["d"])[(keys.long() % n).clamp(0, n - 1)])
    top = int(level_runs_plain(keys, n, l_max)[1].max())
    assert top <= 3
    tau = float(case["tau"])

    def run(start):
        acc = torch.zeros((n, 4))
        for level in range(start, -1, -1):
            nxt = torch.empty_like(acc)
            horner_step_plain(acc, nxt, lay, keys, contrib, level, tau)
            if level > top:
                assert torch.count_nonzero(nxt) == 0
            acc = nxt
        return acc

    np.testing.assert_array_equal(run(l_max).numpy(), run(top).numpy())


def test_push_layout_splits_nodes_by_in_degree():
    n = 50
    dst = np.concatenate([np.full(HEAVY_DEGREE + 1, 3), np.full(40, 7),
                          np.arange(n)])
    src = np.arange(len(dst)) % n
    lay = SpmmLayout.from_edges(src, dst, np.ones(len(dst)), n, "cpu")
    assert lay.heavy.tolist() == [3, 7]
    assert sorted(lay.light.tolist() + lay.heavy.tolist()) == list(range(n))
    assert lay.heavy.dtype == lay.light.dtype == torch.int32


@pytest.mark.parametrize("seed", range(3))
def test_push_layout_orders_nodes_in_tiers_of_in_degree(seed):
    """``push_order`` holds every node once, by tier of in-degree
    (PUSH_TIERS: low, mid, wide, big), ascending ids within a tier, and
    ``push_tiers`` the tiers' sizes -- the same on every layout route."""
    rng = np.random.default_rng(seed)
    n = 300
    deg = rng.choice([0, 1, 3, 8, 9, 20, 32, 33, 100, 128, 129, 400], n)
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, len(dst))
    lay = SpmmLayout.from_edges(src, dst, np.ones(len(dst)), n, "cpu")
    tier = np.searchsorted(np.asarray(PUSH_TIERS), deg, side="left")
    want = np.argsort(tier, kind="stable")
    np.testing.assert_array_equal(lay.push_order.numpy(), want)
    assert lay.push_order.dtype == torch.int32
    assert lay.push_tiers == tuple(np.bincount(tier, minlength=4))
    same = SpmmLayout(n=n, in_ptr=lay.in_ptr, in_idx=lay.in_idx, w=lay.w,
                      heavy=lay.heavy, light=lay.light)
    assert torch.equal(same.push_order, lay.push_order)
    assert same.push_tiers == lay.push_tiers


def test_push_backend_resolves_by_device():
    assert resolve_push_backend("auto", "cpu") == "plain"
    assert resolve_push_backend("auto", "cuda") == "kernel"
    assert resolve_push_backend("kernel", "cpu") == "kernel"
    with pytest.raises(ValueError):
        resolve_push_backend("pallas", "cpu")


# ----------------------------------------------------------------------
# spmm (the Â operator)
# ----------------------------------------------------------------------
SPMM_CASES = {
    "ba40-deg2-F8": dict(n=40, deg=2, f=8),
    "ba40-deg5-F24": dict(n=40, deg=5, f=24),
    "ba100-deg2-F1": dict(n=100, deg=2, f=1),
    "ba100-deg5-F16": dict(n=100, deg=5, f=16),
    "sinks-F8": dict(sinks=True, f=8),
    "multigraph-F24": dict(multigraph=True, f=24),
}


def _spmm_graph(n=0, deg=0, sinks=False, multigraph=False):
    """A reference graph and the port's copy of it (in-degree 0 rows in
    the sinks case, parallel edges in the multigraph case)."""
    if sinks:
        r = rgen.with_sinks(40, 120, n_sinks=5, seed=7)
    elif multigraph:
        r = rgen.multigraph(32, 90, seed=9)
    else:
        r = rgen.barabasi_albert(n, deg, seed=n + deg, directed=True)
    return r, convert.graph_from_arrays(r.n, r.edge_src, r.edge_dst)


@pytest.mark.parametrize("layout", ["pull", "push"])
@pytest.mark.parametrize("case", SPMM_CASES)
def test_spmm_plain_matches_reference_kernel(case, layout):
    """spmm_plain against the reference's Pallas kernel (interpret mode)
    and its segment-sum reference. The push layout is the kernel over
    the reversed graph with each edge keeping its destination's pull
    weight (the reference's transpose=True)."""
    kw = dict(SPMM_CASES[case])
    f = kw.pop("f")
    r, t = _spmm_graph(**kw)
    sc = 0.7746
    w = rcsr.normalized_pull_weights(r, sc)
    x = np.random.default_rng(0).normal(size=(r.n, f)).astype(np.float32)
    if layout == "pull":
        rg, rw = r, w
        seg = spmm_ref(jnp.asarray(x), jnp.asarray(r.edge_src),
                       jnp.asarray(r.edge_dst), jnp.asarray(w), r.n)
    else:
        rg = rcsr.from_edges(r.n, r.edge_dst, r.edge_src, dedup=False)
        rw = w[np.argsort(r.edge_src, kind="stable")]
        seg = spmm_ref(jnp.asarray(x), jnp.asarray(r.edge_dst),
                       jnp.asarray(r.edge_src), jnp.asarray(w), r.n)
    ref_k = np.asarray(rspmm.spmm(x, rg, rw, bn=8, eb=16))
    lay = getattr(SpmmLayout, layout)(t, sc, "cpu")
    got = spmm_plain(torch.as_tensor(x), lay).numpy()
    np.testing.assert_allclose(got, ref_k, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(seg), atol=ATOL, rtol=0)
    # on the CPU the wrapper takes the plain version, into ``out``
    out = torch.empty(r.n, f)
    assert spmm(torch.as_tensor(x), lay, out=out) is out
    np.testing.assert_array_equal(out.numpy(), got)
    if kw.get("sinks"):
        zero = np.flatnonzero(np.diff(lay.in_ptr.numpy()) == 0)
        assert len(zero) and np.all(got[zero] == 0.0)


def test_spmm_push_layout_is_the_transpose():
    """On a graph with non-uniform in-degrees the push layout applies
    the transpose of the pull operator: the weight of an out-edge is
    its destination's, not its source's."""
    g = tgen.barabasi_albert(50, 3, seed=4, directed=True)
    assert len(set(g.in_deg.tolist())) > 3
    pull = SpmmLayout.pull(g, 0.8, "cpu")
    push = SpmmLayout.push(g, 0.8, "cpu")
    A = np.zeros((g.n, g.n))
    for v in range(g.n):
        lo, hi = int(pull.in_ptr[v]), int(pull.in_ptr[v + 1])
        np.add.at(A[v], pull.in_idx[lo:hi].numpy(), pull.w[lo:hi].numpy())
    x = np.random.default_rng(1).random((g.n, 5)).astype(np.float32)
    np.testing.assert_allclose(spmm(torch.as_tensor(x), pull).numpy(),
                               A @ x, atol=1e-6)
    np.testing.assert_allclose(spmm(torch.as_tensor(x), push).numpy(),
                               A.T @ x, atol=1e-6)


def test_spmm_column_does_not_depend_on_its_block():
    """A column propagated alone equals the same column inside a wider
    block, bit for bit: the row repair relies on it."""
    g = tgen.barabasi_albert(64, 3, seed=1, directed=False)
    lay = SpmmLayout.pull(g, 0.77, "cpu")
    x = torch.as_tensor(np.random.default_rng(2).random((g.n, 37)),
                        dtype=torch.float32)
    wide = spmm(x, lay)
    for j in (0, 17, 36):
        assert torch.equal(spmm(x[:, j:j + 1].contiguous(), lay)[:, 0],
                           wide[:, j])


def test_spmm_wrapper_rejects_bad_arguments():
    lay = SpmmLayout.from_edges([0, 1], [2, 3], [0.5, 0.5], 6, "cpu")
    x = torch.zeros((6, 4))
    with pytest.raises(ValueError):
        spmm(torch.zeros((5, 4)), lay)
    with pytest.raises(TypeError):
        spmm(x.double(), lay)
    with pytest.raises(ValueError):
        spmm(torch.zeros((4, 6)).t(), lay)
    with pytest.raises(ValueError):
        spmm(x, lay, out=torch.zeros((6, 3)))
