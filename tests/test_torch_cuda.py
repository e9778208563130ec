"""The port's Hopper kernels on the card, each held against its plain
PyTorch version; and the rule that a CUDA tensor runs the kernel or
raises. Every test here needs an NVIDIA card and nvcc and skips
without one:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cin import (cin_forward,
                                     cin_forward_reference, cin_grad_w,
                                     cin_grad_x0, cin_grad_xk, cin_layer,
                                     cin_layer_backward_plain, cin_layer_ref)
from repro_torch.kernels.cin.cin import (depth_split, split_grad_rows,
                                         split_grad_rows_on_card,
                                         split_grad_t,
                                         split_grad_t_on_card, split_weights,
                                         split_weights_on_card,
                                         split_weights_x0,
                                         split_weights_x0_on_card)
from repro_torch.graph import generators
from repro_torch.core import hp_index
from repro_torch.core.single_source import slab_horner_push
from repro_torch.kernels.horner_push import (MAX_SLABS, Slab,
                                             horner_push_rows,
                                             horner_push_rows_plain,
                                             horner_push_slabs,
                                             horner_push_slabs_plain,
                                             persistent_grid,
                                             workspace_numel)
from repro_torch.kernels.hp_join import hp_join, hp_join_plain
from repro_torch.kernels.spmv_ell import (HEAVY_DEGREE, SpmmLayout,
                                          segment_live, spmm, spmm_plain)
from torch_cases import (JOIN_CASES, condition_lm, join_rows, port_join,
                         table_case)

ATOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no "
                    "interpret mode; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wrappers_raise_without_library_on_card(card, monkeypatch, tmp_path):
    """A CUDA tensor either runs the kernel or raises: with no nvcc and
    no built library the wrappers raise instead of falling back."""
    # the packages re-export functions under their modules' names
    hp_mod = importlib.import_module(
        "repro_torch.kernels.horner_push.horner_push")
    hj_mod = importlib.import_module("repro_torch.kernels.hp_join.hp_join")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(hj_mod, "_launch", [])
    monkeypatch.setattr(hp_mod, "_launch", [])
    keys = torch.zeros((2, 64), dtype=torch.int32, device=card)
    ids = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="nvcc"):
        hp_join(keys, keys.float(), ids, ids)
    lay = SpmmLayout.from_edges([0], [1], [0.5], 2, card)
    before = horner_push_rows.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        horner_push_rows(keys, keys.float(), torch.ones(2, device=card), ids,
                         lay, 0.0, l_max=0)
    assert horner_push_rows.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", JOIN_CASES)
def test_hp_join_kernel_matches_plain_on_card(card, case):
    rng = np.random.default_rng(sorted(JOIN_CASES).index(case))
    ku, vu, kv, vv = join_rows(rng, **JOIN_CASES[case])
    B = ku.shape[0]
    keys = torch.as_tensor(np.concatenate([ku, kv]), device=card)
    vals = torch.as_tensor(np.concatenate([vu, vv]), device=card)
    us = torch.arange(B, dtype=torch.int32, device=card)
    before = hp_join.launches
    got = hp_join(keys, vals, us, us + B)
    assert hp_join.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               port_join(ku, vu, kv, vv), atol=ATOL, rtol=0)


def _push_on_card(case, n, l_max, card, B, ids=torch.int64, seed=0,
                  workspace=None):
    """The kernel push and the plain push on the card on B rows of the
    case's table, picked by id: (kernel result, plain result)."""
    lay = SpmmLayout.from_edges(case["src"], case["dst"], case["w"], n, card)
    keys, vals, d = (torch.as_tensor(case[k], device=card)
                     for k in ("ku", "xu", "d"))
    us = torch.as_tensor(np.random.default_rng(seed).integers(
        0, keys.shape[0], B), dtype=ids, device=card)
    tau = float(case["tau"])
    launches, steps = horner_push_rows.launches, horner_push_rows.steps
    got = horner_push_rows(keys, vals, d, us, lay, tau, l_max=l_max,
                           workspace=workspace)
    assert horner_push_rows.launches == launches + 1
    assert horner_push_rows.steps == steps + l_max + 1
    plain = horner_push_rows_plain(keys, vals, d, us, lay, tau, l_max=l_max)
    torch.cuda.synchronize()
    return got, plain


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_horner_kernel_matches_plain_on_card(card, seed):
    """Random graphs with a hub above the heavy split, batch widths that
    do and do not divide the kernel's column groups (1, 3, 8, 9, 32,
    300), int32 and int64 row ids, one push of one launch each."""
    rng = np.random.default_rng(seed)
    n, l_max = 40 + 7 * seed, 4
    B = [1, 3, 8, 9, 32, 300][seed]
    case = table_case(rng, n=n, rows=64, W=6, l_max=l_max, m=4 * n,
                      hubs=(seed % n,),
                      tau=[0.0, 1e-4, 5e-2, 1e9, 1e-4, 0.0][seed])
    got, plain = _push_on_card(case, n, l_max, card, B, seed=seed,
                               ids=torch.int32 if seed % 2 else torch.int64)
    assert got.shape == (B, n)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 16, 300])
def test_push_rows_with_hubs_match_plain_on_card(card, B):
    """Hubs of in-degree 120 and more (above the heavy split of 32),
    duplicate keys in the rows, every level seeded."""
    rng = np.random.default_rng(B)
    n, l_max = 500, 6
    case = table_case(rng, n=n, rows=400, W=40, l_max=l_max, m=6 * n,
                      hubs=(0, 7, 7, 19, 250), dup=True)
    got, plain = _push_on_card(case, n, l_max, card, B, seed=B)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1024, 1028, 2048])
def test_push_rows_at_the_sling_serve_batch_on_card(card, B):
    """The sling-serve config's batch of 1,024 sources in one launch:
    256 column groups of 4, one slot a big row (a group of 256 threads),
    the mid and wide rows run with their neighbours; 1,028 (257 groups,
    more than a group's threads) and 2,048 take the path where a thread
    owns whole column groups of a big row."""
    rng = np.random.default_rng(B)
    n, l_max = 700, 12
    case = table_case(rng, n=n, rows=1500, W=24, l_max=l_max, m=6 * n,
                      hubs=(0, 3, 3, 3, 99, 400), dup=True)
    got, plain = _push_on_card(case, n, l_max, card, B, seed=B)
    assert got.shape == (B, n) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 16, 300])
def test_push_rows_on_a_graph_smaller_than_the_grid_on_card(card, B):
    """n = 5 nodes: the grid is capped at a level's work, and most
    threads of a block have nothing to do."""
    rng = np.random.default_rng(10 + B)
    n, l_max = 5, 3
    case = table_case(rng, n=n, rows=9, W=4, l_max=l_max, m=12, hubs=(2,))
    assert persistent_grid(
        SpmmLayout.from_edges(case["src"], case["dst"], case["w"], n,
                              card), B) >= 1
    got, plain = _push_on_card(case, n, l_max, card, B, seed=B)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def enron_case():
    """The Enron regime: n = 36,692, m = 146,712 (paper_scale), rows of
    width 832 holding keys at levels 0 .. 12 of l_max = 29."""
    g = generators.paper_scale("Enron", seed=0)
    rng = np.random.default_rng(0)
    rows, W, l_max = 64, 832, 29
    lv = np.minimum(rng.geometric(0.3, (rows, W)) - 1, 12)
    ku = np.sort((lv * g.n + rng.integers(0, g.n, (rows, W))).astype(
        np.int32), axis=1)
    ku[:, 700:] = np.iinfo(np.int32).max
    w = (0.7745967 / np.maximum(np.bincount(g.edge_dst, minlength=g.n), 1)
         )[g.edge_dst].astype(np.float32)
    return dict(src=g.edge_src, dst=g.edge_dst, w=w, ku=ku,
                xu=rng.uniform(1e-4, 0.05, (rows, W)).astype(np.float32),
                d=rng.uniform(0.4, 1.0, g.n).astype(np.float32),
                tau=np.float32(7.3e-7)), g.n, l_max


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 16])
def test_push_rows_at_the_enron_size_on_card(card, enron_case, B):
    case, n, l_max = enron_case
    got, plain = _push_on_card(case, n, l_max, card, B, seed=B)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_push_rows_two_pushes_give_the_same_bits_on_card(card, enron_case):
    case, n, l_max = enron_case
    a, _ = _push_on_card(case, n, l_max, card, 8, seed=3)
    b, _ = _push_on_card(case, n, l_max, card, 8, seed=3)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 9])
def test_push_rows_ignore_a_nan_workspace_on_card(card, B):
    """The workspace may hold anything: a NaN-filled one leaves no NaN
    in the result, for 4-column and 1-column thread walks."""
    rng = np.random.default_rng(B)
    n, l_max = 300, 5
    case = table_case(rng, n=n, rows=50, W=30, l_max=l_max, m=5 * n,
                      hubs=(3,))
    ws = torch.full((workspace_numel(n, B, l_max),), float("nan"),
                    device=card)
    got, plain = _push_on_card(case, n, l_max, card, B, workspace=ws)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=ATOL, rtol=0)


HP_JOIN_EDGES = {
    "duplicate-keys-K37": dict(B=40, K=37, key_range=12, dup=True),
    "all-pad-rows-K130": dict(B=24, K=130, key_range=400,
                              pad_rows=(0, 5, 23)),
    "K-832": dict(B=256, K=832, key_range=3000),
    "K-837": dict(B=64, K=837, key_range=2500, dup=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", HP_JOIN_EDGES)
def test_hp_join_block_a_pair_edge_cases_on_card(card, case):
    """One block a pair: duplicate keys, all-PAD rows, K not a multiple
    of 4, 32 or the block (scalar copies into shared memory), u == v,
    and two calls with the same bits."""
    rng = np.random.default_rng(sorted(HP_JOIN_EDGES).index(case))
    ku, vu, kv, vv = join_rows(rng, **HP_JOIN_EDGES[case])
    # folded values h * sqrt(d) are small: scale the rows so that a
    # pair's score stays at SimRank's scale (<= 1) at every K
    vu, vv = vu * 0.05, vv * 0.05
    B = ku.shape[0]
    keys = torch.as_tensor(np.concatenate([ku, kv]), device=card)
    vals = torch.as_tensor(np.concatenate([vu, vv]), device=card)
    us = torch.arange(B, dtype=torch.int32, device=card)
    for vs in (us + B, us, us.flip(0)):   # u != v, u == v, mixed
        got = hp_join(keys, vals, us, vs)
        np.testing.assert_allclose(
            got.cpu().numpy(), hp_join_plain(keys, vals, us, vs).cpu().numpy(),
            atol=ATOL, rtol=0)
        assert torch.equal(got, hp_join(keys, vals, us, vs))


@pytest.mark.cuda
def test_spmm_raises_without_library_on_card(card, monkeypatch, tmp_path):
    sp_mod = importlib.import_module("repro_torch.kernels.spmv_ell.spmv_ell")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(sp_mod, "_launch", [])
    lay = SpmmLayout.from_edges([0], [1], [0.5], 2, card)
    before = spmm.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        spmm(torch.zeros((2, 4), device=card), lay)
    assert spmm.launches == before


def _spmm_case(seed, n, f):
    """A random graph with hub rows above the heavy split in both
    directions (in-hubs 1 and 2, out-hub 3), rows of in-degree 0, and n
    not a multiple of the kernel's block."""
    rng = np.random.default_rng(seed)
    m = 3 * n
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n // 2, m)          # rows >= n/2: in-degree 0
    hubs = np.repeat([1, 2], [HEAVY_DEGREE + 1, 10 * HEAVY_DEGREE])
    out_hub = np.full(5 * HEAVY_DEGREE, 3)
    src = np.concatenate([src, rng.integers(0, n, len(hubs)), out_hub])
    dst = np.concatenate([dst, hubs, rng.integers(0, n // 2, len(out_hub))])
    w = rng.uniform(0.05, 0.6, len(src)).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return src, dst, w, x


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 16, 256])
@pytest.mark.parametrize("n", [300, 1001])
def test_spmm_kernel_matches_plain_on_card(card, n, f):
    src, dst, w, x = _spmm_case(n + f, n, f)
    for a, b in ((src, dst), (dst, src)):     # pull and transposed
        lay = SpmmLayout.from_edges(a, b, w, n, card)
        assert lay.heavy.numel() >= 1
        xt = torch.as_tensor(x, device=card)
        before = spmm.launches
        got = spmm(xt, lay)
        torch.cuda.synchronize()
        assert spmm.launches == before + 1
        ref = spmm_plain(xt, lay)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   atol=ATOL, rtol=0)
        deg = np.diff(lay.in_ptr.cpu().numpy())
        assert np.all(got.cpu().numpy()[deg == 0] == 0.0)


@pytest.mark.cuda
def test_spmm_column_is_bit_exact_in_any_block_on_card(card):
    src, dst, w, x = _spmm_case(3, 700, 256)
    lay = SpmmLayout.from_edges(src, dst, w, 700, card)
    xt = torch.as_tensor(x, device=card)
    wide = spmm(xt, lay)
    for j in (0, 31, 32, 200, 255):
        for lo in (j, max(0, j - 5)):
            part = spmm(xt[:, lo:j + 1].contiguous(), lay)
            assert torch.equal(part[:, j - lo], wide[:, j])


@pytest.mark.cuda
def test_repair_on_card_equals_fresh_build(card):
    """Row repair on the card reproduces a fresh card build of the new
    graph bit for bit, for every row and every target."""
    from repro_torch.core import build, hp_index, update
    from repro_torch.graph import csr, generators
    g = generators.barabasi_albert(400, 4, seed=3, directed=False)
    idx = build.build_index(g, eps=0.1, exact_d=True, device=card)
    g2, touched, _ = csr.apply_edges(
        g, update.random_delta(g, n_add=10, n_del=10, seed=1))
    assert len(touched) > 0
    every = np.arange(g.n)
    hp_index.repair_hp_rows(g2, idx.hp, every, every, block=64)
    fresh = build.build_index(g2, eps=0.1, exact_d=True, device=card)
    assert torch.equal(idx.hp.counts, fresh.hp.counts)
    c = int(fresh.hp.counts.max())
    assert torch.equal(idx.hp.keys[:, :c], fresh.hp.keys[:, :c])
    assert torch.equal(idx.hp.vals[:, :c], fresh.hp.vals[:, :c])


def _masked_step(x, lay, tau):
    """One masked step as the build takes it, held against the dense
    kernel on the pruned x (equal bits), the plain version (ATOL) and
    segment_live (equal masks). Returns the output."""
    live = segment_live(x, tau)
    live_out = torch.full_like(live, -1)
    before = spmm.launches
    got = spmm(x, lay, tau=tau, live=live, live_out=live_out)
    torch.cuda.synchronize()
    assert spmm.launches == before + 1
    dense = spmm(torch.where(x > tau, x, 0.0), lay)
    assert torch.equal(got, dense)
    assert torch.equal(got, spmm(x, lay, tau=tau))      # no mask
    assert torch.equal(live_out, segment_live(got, tau))
    np.testing.assert_allclose(got.cpu().numpy(),
                               spmm_plain(x, lay, tau=tau).cpu().numpy(),
                               atol=ATOL, rtol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 16, 256, 257, 1100])
@pytest.mark.parametrize("n", [300, 1001])
def test_spmm_masked_equals_dense_on_sparse_slabs_on_card(card, n, f):
    """Slabs with ~10% of entries above tau, both layouts (hub rows in
    both directions), F = 1100 with two mask words a row; F = 16, 256
    and 1100 also from a slab that is not 16-byte aligned (the scalar
    path), with equal bits."""
    src, dst, w, x = _spmm_case(n + f, n, f)
    x = np.abs(x) * (np.random.default_rng(f).random(x.shape) < 0.1)
    tau = 0.5
    for a, b in ((src, dst), (dst, src)):
        lay = SpmmLayout.from_edges(a, b, w, n, card)
        xt = torch.as_tensor(x, dtype=torch.float32, device=card)
        got = _masked_step(xt, lay, tau)
        if f % 4 == 0:
            odd = torch.empty(n * f + 1, device=card)[1:].view(n, f)
            odd.copy_(xt)
            assert odd.data_ptr() % 16 != 0
            assert torch.equal(_masked_step(odd, lay, tau), got)


@pytest.mark.cuda
def test_spmm_masked_build_frontiers_on_card(card):
    """Every step of a pruned build block (256 targets on a power-law
    graph with hubs) until the stop test: masked == dense bit for bit,
    live_out == segment_live, within ATOL of the plain version."""
    from repro_torch.graph import generators
    g = generators.barabasi_albert(3000, 4, seed=5, directed=True)
    lay = SpmmLayout.pull(g, 0.6 ** 0.5, card)
    assert lay.heavy.numel() >= 1
    tau = float(np.float32(2e-3))
    h = torch.zeros((g.n, 256), device=card)
    h[torch.arange(256), torch.arange(256)] = 1.0
    steps = 0
    while bool((h > tau).any()) and steps < 30:
        h = _masked_step(h, lay, tau)
        steps += 1
    assert steps >= 3


@pytest.mark.cuda
def test_spmm_masked_column_is_bit_exact_in_any_block_on_card(card):
    """A column propagated alone through three masked steps equals the
    same column inside the block (F = 256 vector path vs F = 1 scalar
    path) bit for bit."""
    src, dst, w, x = _spmm_case(5, 700, 256)
    lay = SpmmLayout.from_edges(src, dst, w, 700, card)
    tau = 0.05
    wide = torch.as_tensor(np.abs(x), device=card)
    cols = {j: wide[:, j:j + 1].contiguous() for j in (0, 31, 32, 200, 255)}
    for _ in range(3):
        live = segment_live(wide, tau)
        wide = spmm(wide, lay, tau=tau, live=live,
                    live_out=torch.empty_like(live))
        for j, c in cols.items():
            lc = segment_live(c, tau)
            cols[j] = spmm(c, lay, tau=tau, live=lc,
                           live_out=torch.empty_like(lc))
            assert torch.equal(cols[j][:, 0], wide[:, j])
    assert bool((wide > tau).any())


@pytest.mark.cuda
def test_cin_raises_without_library_on_card(card, monkeypatch, tmp_path):
    cin_mod = importlib.import_module("repro_torch.kernels.cin.cin")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(cin_mod, "_launch", [])
    x0 = torch.zeros((4, 3, 2), device=card)
    before = cin_layer.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        cin_layer(x0, x0, torch.zeros((5, 3, 3), device=card))
    assert cin_layer.launches == before


def _cin_case(seed, B, m, h, hp, D):
    """O(1)-scale inputs: unit normal x0 and xk, W scaled by
    1/sqrt(h*m), so max |out| is a few units."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, m, D)).astype(np.float32),
            rng.normal(size=(B, h, D)).astype(np.float32),
            (rng.normal(size=(hp, h, m)) / np.sqrt(h * m)).astype(np.float32))


# ragged B (rows B*D not a multiple of the 128-row tile), h, m and h'
# (not a multiple of the 200-map tile); m = 70 the largest x0 slab in
# shared memory. Then the tensor-core design's edges: K = h*m = 1,521
# ragged against the 8-deep wgmma step and the 32-deep tile, with a
# 6-way depth split whose chunk boundaries (multiples of 256 in k) fall
# inside an `a` of m = 39; h' = 65 not a multiple of 8; B*D = 50 rows,
# below one warpgroup's 64; h' = 450, three column tiles and a 30-way
# split; 200,000 rows, enough tiles (1,563) for the persistent grid
CIN_SHAPES = [(13, 4, 4, 6, 4), (64, 8, 8, 8, 8), (37, 5, 3, 65, 10),
              (200, 39, 39, 200, 10), (3, 70, 17, 129, 7),
              (16, 39, 39, 200, 10), (24, 39, 40, 65, 10),
              (5, 39, 20, 200, 10), (7, 39, 200, 450, 10),
              (20_000, 39, 39, 200, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CIN_SHAPES, ids=str)
def test_cin_kernel_matches_plain_on_card(card, shape):
    """Relative to max |out| (float32 reduction order), as the
    reference's kernel test holds its kernel (rtol 2e-5)."""
    x0, xk, W = (torch.as_tensor(a, device=card)
                 for a in _cin_case(sum(shape), *shape))
    before = cin_layer.launches
    got = cin_layer(x0, xk, W)
    torch.cuda.synchronize()
    assert cin_layer.launches == before + 1
    assert got.shape == (shape[0], shape[3], shape[4])
    ref = cin_layer_ref(x0.double(), xk.double(), W.double())
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max()) / scale
    plain = float((cin_layer(x0, xk, W, backend="plain").double()
                   - ref).abs().max()) / scale
    assert err <= 2e-5, (err, plain)


@pytest.mark.cuda
def test_cin_full_width_layer_on_card(card):
    """One 200 -> 200 layer of xdeepfm.full() (m = 39, D = 10) at the
    serve batch of 512."""
    x0, xk, W = (torch.as_tensor(a, device=card)
                 for a in _cin_case(5, 512, 39, 200, 200, 10))
    got = cin_layer(x0, xk, W)
    ref = cin_layer(x0, xk, W, backend="plain")
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 2e-5 * scale
    stack = cin_forward(x0, [W[:, :39].contiguous(), W, W])
    plain = cin_forward_reference(x0, [W[:, :39].contiguous(), W, W])
    assert stack.shape == (512, 600)
    assert float((stack - plain).abs().max()) <= \
        2e-5 * float(plain.abs().max())


@pytest.mark.cuda
def test_cin_routes_grad_tensors_through_cinlayer_on_card(card):
    """A tensor that records a gradient goes through the autograd
    Function (whose backward runs the gradient kernels); under no_grad
    the wrapper launches the layer kernel alone and records nothing."""
    x0, xk, W = (torch.as_tensor(a, device=card)
                 for a in _cin_case(1, 8, 4, 4, 6, 3))
    W.requires_grad_(True)
    before = cin_layer.launches
    out = cin_layer(x0, xk, W)
    assert type(out.grad_fn).__name__ == "CinLayerBackward"
    assert cin_layer.launches == before + 1
    with torch.no_grad():
        plain = cin_layer(x0, xk, W)
        assert plain.shape == (8, 6, 3) and plain.grad_fn is None
    assert cin_layer.launches == before + 2
    assert torch.equal(out.detach(), plain)


# (B, m, h, h', D) of the gradient cases: small and ragged; xDeepFM's
# layer 1 (h = m = 39: dx0's column tile holds J = 5 whole j of h8 = 40
# columns) and layers 2-3 (h = 200: J = 1); h' = 450 (three column tiles
# of dW); m = 130 past the layer's slab and past dW's 128 staged x0 rows;
# the serve batch at full width. Then the redesign's edges: h = 17
# (h8 = 24, J = 8 with 8 columns of the tile past the unit's j); h = 201
# and 450 (h8 = 208 and 456: one j walks 2 and 3 column tiles); h' = 13
# and 203, not multiples of 8 (the last k-tile's live k8 steps); B*D =
# 130 and 290 rows, not multiples of 128; m = 1 (dW stages 1 x0 row and
# up to 128 xk rows a depth tile)
CIN_GRAD_SHAPES = [(13, 4, 4, 6, 4), (37, 5, 3, 65, 10),
                   (64, 39, 39, 200, 10), (16, 39, 200, 200, 10),
                   (5, 39, 200, 450, 10), (3, 130, 17, 129, 7),
                   (512, 39, 200, 200, 10),
                   (29, 39, 17, 200, 10), (7, 12, 201, 33, 10),
                   (6, 39, 450, 70, 10), (40, 39, 200, 203, 10),
                   (13, 39, 200, 200, 10), (29, 7, 39, 13, 10),
                   (50, 1, 200, 200, 10), (20, 1, 1, 3, 5)]


def _grad_case(seed, B, m, h, hp, D, card):
    x0, xk, W = (torch.as_tensor(a, device=card)
                 for a in _cin_case(seed, B, m, h, hp, D))
    g = torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=(B, hp, D)).astype(np.float32), device=card)
    return x0, xk, W, g


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CIN_GRAD_SHAPES, ids=str)
def test_cin_grad_kernels_match_plain_on_card(card, shape):
    """Each gradient kernel against the plain formulas in float64,
    relative to the gradient's max |value| (TOL_CIN = 2e-5); one launch
    each."""
    x0, xk, W, g = _grad_case(sum(shape), *shape, card)
    refs = cin_layer_backward_plain(x0.double(), xk.double(), W.double(),
                                    g.double())
    for fn, ref in zip((cin_grad_x0, cin_grad_xk, cin_grad_w), refs):
        before = fn.launches
        got = fn(x0, xk, W, g)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == ref.shape and got.dtype == torch.float32
        err = float((got.double() - ref).abs().max() / ref.abs().max())
        assert err <= 2e-5, (fn.__name__, err)


@pytest.mark.cuda
def test_cin_layer_streams_a_wide_x0_on_card(card):
    """The layer with m = 200 in the x0 slot (past the shared-memory
    slab's 123): x0 read from device memory, within 2e-5."""
    x0, xk, W = (torch.as_tensor(a, device=card)
                 for a in _cin_case(11, 64, 200, 39, 200, 10))
    got = cin_layer(x0, xk, W)
    ref = cin_layer_ref(x0.double(), xk.double(), W.double())
    assert float((got.double() - ref).abs().max()) <= \
        2e-5 * float(ref.abs().max())


def _cin_kernel_modes(fn, *args):
    """The modes of csrc/cin.cu's GEMM kernels that one call of ``fn``
    launched, from a profiler trace: cin_kernel's 0 layer (slab), 1 layer
    (x0 streamed), 2 dW, and 3 for cin_x0grad_kernel (dx0). A trace with
    no cin kernel in it fails with what the trace did hold."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    raw = prof.profiler.kineto_results.events()
    assert any("cin_" in n for n in names), (
        f"{fn.__name__}'s trace holds no cin kernel: {len(names)} events "
        f"({len(raw)} kineto records): {sorted(set(names))[:12]}")
    return {mode for n in names if "cin_kernel" in n for mode in range(3)
            if f"<{mode}>" in n or f"ILi{mode}E" in n} | \
        {3 for n in names if "cin_x0grad_kernel" in n}


@pytest.mark.cuda
@pytest.mark.parametrize("h", [39, 200])
def test_cin_grad_x0_runs_the_dx0_gemm_on_card(card, h):
    """dx0 of xDeepFM's layer 1 (h = 39) and of a 200-wide layer runs
    dx0's kernel (3), never the layer kernel's modes: one launch, within
    2e-5 of float64."""
    x0, xk, W, g = _grad_case(h, 512, 39, h, 200, 10, card)
    assert _cin_kernel_modes(cin_grad_x0, x0, xk, W, g) == {3}
    assert _cin_kernel_modes(cin_grad_w, x0, xk, W, g) == {2}
    before = cin_grad_x0.launches
    got = cin_grad_x0(x0, xk, W, g)
    torch.cuda.synchronize()
    assert cin_grad_x0.launches == before + 1
    ref = cin_layer_backward_plain(x0.double(), xk.double(), W.double(),
                                   g.double())[0]
    assert float((got.double() - ref).abs().max()) <= \
        2e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 200, 10), (13, 65, 10),
                                   (3, 7, 3), (1, 1, 1)], ids=str)
def test_cin_grad_pre_passes_equal_plain_bits_on_card(card, shape):
    """dW's pre-pass (g transposed to (h', B*D) in two TF32 parts), dx0's
    (g by rows, (B*D, h')) and dx0's split of W permuted to (m*h8, h')
    equal their plain versions bit for bit, pads included."""
    B, hp, D = shape
    g = torch.as_tensor(np.random.default_rng(B).normal(
        size=shape).astype(np.float32), device=card)
    gt = split_grad_t_on_card(g)
    assert gt.shape == (2, hp, -(-B * D // 4) * 4)
    assert torch.equal(gt, split_grad_t(g))
    g2 = split_grad_rows_on_card(g)
    assert g2.shape == (2, B * D, -(-hp // 4) * 4)
    assert torch.equal(g2, split_grad_rows(g))
    for h, m in ((39, 39), (200, 39), (17, 5), (450, 2)):
        W = torch.as_tensor(_cin_case(h, 1, m, h, hp, 1)[2], device=card)
        assert torch.equal(split_weights_x0_on_card(W), split_weights_x0(W))


@pytest.mark.cuda
def test_cin_grads_two_calls_give_the_same_bits_on_card(card):
    """No atomics: the depth chunks are summed in chunk order, dx0's
    quads in a fixed order."""
    for h in (200, 39):
        x0, xk, W, g = _grad_case(3, 512, 39, h, 200, 10, card)
        for fn in (cin_grad_x0, cin_grad_xk, cin_grad_w):
            assert torch.equal(fn(x0, xk, W, g), fn(x0, xk, W, g))


@pytest.mark.cuda
def test_cin_autograd_never_runs_the_plain_path_on_card(card, monkeypatch):
    """The CIN stack under autograd on CUDA tensors runs the forward and
    the three gradient kernels and none of the plain formulas; its
    gradients match autograd through the plain stack."""
    cin_mod = importlib.import_module("repro_torch.kernels.cin.cin")
    rng = np.random.default_rng(5)
    B, m, D = 40, 39, 10
    x0 = torch.as_tensor(rng.normal(size=(B, m, D)).astype(np.float32),
                         device=card)
    Ws = [torch.as_tensor((rng.normal(size=s) / np.sqrt(s[1] * s[2]))
                          .astype(np.float32), device=card)
          for s in ((200, 39, 39), (200, 200, 39), (120, 200, 39))]
    cot = torch.as_tensor(rng.normal(size=(B, 520)).astype(np.float32),
                          device=card)

    def grads(backend):
        leaves = [x0.clone().requires_grad_(True)] + \
            [w.clone().requires_grad_(True) for w in Ws]
        out = cin_forward(leaves[0], leaves[1:], backend=backend)
        return torch.autograd.grad(out, leaves, cot)

    want = grads("plain")

    def refuse(*_a, **_k):
        raise AssertionError("a plain CIN formula ran on the card")
    for name in ("cin_layer_ref", "cin_grad_xk_plain", "cin_grad_x0_plain",
                 "cin_grad_w_plain"):
        monkeypatch.setattr(cin_mod, name, refuse)
    before = [f.launches for f in (cin_layer, cin_grad_x0, cin_grad_xk,
                                   cin_grad_w)]
    got = grads("auto")
    torch.cuda.synchronize()
    after = [f.launches for f in (cin_layer, cin_grad_x0, cin_grad_xk,
                                  cin_grad_w)]
    assert [a - b for a, b in zip(after, before)] == [3, 3, 3, 3]
    for gg, ww in zip(got, want):
        assert float((gg - ww).abs().max()) <= 2e-5 * float(ww.abs().max())


@pytest.mark.cuda
def test_cin_grads_raise_without_library_on_card(card, monkeypatch,
                                                 tmp_path):
    cin_mod = importlib.import_module("repro_torch.kernels.cin.cin")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(cin_mod, "_launch", [])
    x0, xk, W, g = _grad_case(2, 4, 3, 3, 5, 2, card)
    for fn in (cin_grad_x0, cin_grad_xk, cin_grad_w):
        before = fn.launches
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(x0, xk, W, g)
        assert fn.launches == before


@pytest.mark.cuda
def test_recsys_train_step_on_card_matches_cpu(card):
    """One xDeepFM smoke train step from the same parameters and batch on
    the card (CIN kernels forward and backward) and on the CPU (plain):
    equal losses to float32 order, parameters within 1e-3 of lr but on
    near-zero gradients whose sign may flip (at most 2 lr)."""
    from repro_torch.configs import xdeepfm
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.models import recsys
    from repro_torch.optim.adamw import AdamW, named_leaves
    from repro_torch.train.steps import recsys_train_step
    cfg = xdeepfm.smoke()
    lr = 1e-3
    opt = AdamW(lr=lr)
    batch = RecsysStream(cfg.n_fields, cfg.vocab_per_field, 64,
                         cfg.multi_hot_fields, cfg.bag_size).batch_at(0)
    out = {}
    for dev in ("cpu", card):
        model = recsys.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu").to(dev)
        step = recsys_train_step(cfg, opt)
        model, _, m = step(model, opt.init(model), batch)
        out[str(dev)] = (float(m["loss"]), {
            n: p.detach().cpu() for n, p in named_leaves(model)})
    (l_c, p_c), (l_g, p_g) = out["cpu"], out[str(card)]
    assert abs(l_c - l_g) <= 1e-5 * abs(l_c)
    for n in p_c:
        d = (p_c[n] - p_g[n]).abs() / lr
        assert float(d.max()) <= 2.0 + 1e-3, n
        assert int((d > 1e-3).sum()) <= max(1, d.numel() // 1000), n


@pytest.mark.cuda
def test_cin_two_calls_give_the_same_bits_on_card(card):
    """The depth split's partial sums are added in chunk order, never
    with atomics: at the serve batch (s = 3) two calls are equal."""
    x0, xk, W = (torch.as_tensor(a, device=card)
                 for a in _cin_case(7, 512, 39, 200, 200, 10))
    assert depth_split(512 * 10, 200, 200 * 39) == 3
    assert torch.equal(cin_layer(x0, xk, W), cin_layer(x0, xk, W))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 200, 39), (200, 39, 39),
                                   (65, 5, 3)], ids=str)
def test_cin_weight_split_on_card(card, shape):
    """The kernel's split of W: both parts TF32-exact, their sum W to
    ~2^-22, and the same bits as the plain split on the card."""
    hp, h, m = shape
    K = h * m
    W = torch.as_tensor(_cin_case(1, 1, m, h, hp, 1)[2], device=card)
    w2 = split_weights_on_card(W)
    assert torch.equal(w2, split_weights(W))
    assert not bool((w2.view(torch.int32) & 0x1FFF).any())
    assert not bool(w2[:, :, K:].any())
    w = W.reshape(hp, K).double()
    assert bool(((w2[0, :, :K].double() + w2[1, :, :K].double() - w).abs()
                 <= 2.0 ** -22 * w.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["int16", "bf16"])
def test_quantize_on_card_equals_cpu_bits(card, scheme):
    """Codes, scales and the dequantized values computed on the card
    equal the CPU's bit for bit (the CPU's equal the reference's,
    tests/test_torch_quantize.py): the divide is one float32 IEEE divide
    by a device tensor, not a multiply by a host reciprocal."""
    from repro_torch.core import quantize
    rng = np.random.default_rng(7)
    k = rng.integers(0, 32767, 4096)
    v = np.concatenate([(k + 0.5) / 32767, [1.0],
                        rng.lognormal(-6, 1.5, 4096)]).astype(np.float32)
    bound = 1e-3 if scheme == "int16" else 2.0 ** -7
    cpu, s_cpu = quantize.quantize_array(torch.as_tensor(v), scheme, bound)
    gpu, s_gpu = quantize.quantize_array(torch.as_tensor(v, device=card),
                                         scheme, bound)
    assert s_gpu == s_cpu and gpu.dtype == cpu.dtype
    as_int = (lambda t: t.view(torch.int16)) if scheme == "bf16" \
        else (lambda t: t)
    assert torch.equal(as_int(gpu).cpu(), as_int(cpu))
    assert torch.equal(
        quantize.dequantize_array(gpu, scheme, s_gpu).cpu().view(torch.int32),
        quantize.dequantize_array(cpu, scheme, s_cpu).view(torch.int32))
    info = quantize.QuantInfo(scheme="int16", scale=1.0, bound=1.0,
                              d_scale=s_cpu if scheme == "int16" else 1.0)
    d = torch.as_tensor(v[:100])
    assert torch.equal(quantize.quantize_d_codes(d.to(card), info).cpu(),
                       quantize.quantize_d_codes(d, info))


@pytest.mark.cuda
def test_mapped_quantized_index_serves_on_card(card, tmp_path):
    """A mapped file serves on the card through the kernels: float32
    equal in bits to the eagerly loaded index on the card, int16 and
    bf16 uploaded as codes and dequantized there, equal to the same
    index's dequantized values served from the card."""
    from repro_torch.core import build, quantize
    from repro_torch.core.index import SlingIndex
    from repro_torch.serve import EngineConfig, QueryEngine
    g = generators.barabasi_albert(300, 4, seed=3, directed=False)
    cfg = EngineConfig(source_batch=8, pair_batch=64, cache_size=0)
    q = np.arange(0, 300, 11, dtype=np.int32)
    for scheme, eps, frac in ((None, 0.1, 0.25), ("int16", 0.1, 0.25),
                              ("bf16", 0.2, 0.8)):
        idx = build.build_index(g, eps=eps, exact_d=True, quant_frac=frac,
                                device="cpu")
        if scheme:
            idx = quantize.quantize_index(idx, scheme,
                                          quantize_d=scheme == "int16")
        p = str(tmp_path / f"{scheme}.sling")
        idx.save(p)
        mapped = QueryEngine.from_index_file(p, g, cfg, mmap=True,
                                             device=card)
        assert mapped.index.device.type == "cpu"
        assert mapped.stats()["quantized"] == scheme
        eager = QueryEngine(SlingIndex.load(p, device=card), g, cfg,
                            device=card)
        before = (hp_join.launches, horner_push_rows.launches)
        for eng in (mapped, eager):
            assert eng.stats()["pair_backend"] == "kernel"
        a = (mapped.pairs(q, q[::-1]), mapped.single_source(q[:8]),
             mapped.topk(q[:8], 10))
        b = (eager.pairs(q, q[::-1]), eager.single_source(q[:8]),
             eager.topk(q[:8], 10))
        assert hp_join.launches > before[0]
        assert horner_push_rows.launches > before[1]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2][0], b[2][0])
        np.testing.assert_array_equal(a[2][1], b[2][1])


def _canonical_bits(triples):
    """COO triples (tensors or arrays) sorted by (src, key), values as
    their float32 bits."""
    src, key, val = (np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                else x) for x in triples)
    order = np.lexsort((key.astype(np.int64), src.astype(np.int64)))
    return src[order], key[order], val.astype(np.float32)[order].view(
        np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n, eps", [(600, 0.1), (20_000, 0.5)])
def test_sparse_build_on_card_equals_cpu_build(card, n, eps):
    """The sparse build's float64 segment sums are a fixed tree of IEEE
    adds, so the card's table equals the CPU's bit for bit."""
    from repro_torch.core import hp_index, theory
    g = generators.powerlaw_fast(n, seed=4)
    p = theory.plan(eps=eps, c=0.6, n=n)
    cpu = hp_index.build_hp_table_sparse(g, p.theta, p.sqrt_c, p.l_max,
                                         block=256, device="cpu")
    gpu = hp_index.build_hp_table_sparse(g, p.theta, p.sqrt_c, p.l_max,
                                         block=256, device=card)
    assert gpu.keys.device.type == "cuda" and gpu.width == cpu.width
    for a, b in ((gpu.keys, cpu.keys), (gpu.counts, cpu.counts),
                 (gpu.vals.view(torch.int32), cpu.vals.view(torch.int32))):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("n, eps", [(600, 0.1), (20_000, 0.5)])
def test_prsim_equals_sling_on_card(card, n, eps):
    """prsim's hub/tail schedule and the SLING blocks emit the same
    triples bit for bit on the card, and the same as on the CPU."""
    from repro_torch import prsim
    from repro_torch.core import hp_index, theory
    g = generators.powerlaw_fast(n, seed=4)
    p = theory.plan(eps=eps, c=0.6, n=n)
    runs = {}
    for name, dev in (("prsim", card), ("sling", card), ("cpu", "cpu")):
        sink = hp_index._CooSink(None)
        if name == "prsim":
            prsim.build_prsim_coo(g, p, sink, hub_batch=64, tail_block=512,
                                  device=dev)
        else:
            hp_index.sparse_hp_coo(g, p.theta, p.sqrt_c, p.l_max, 1024,
                                   sink, device=dev)
        runs[name] = _canonical_bits(sink.collect())
    for name in ("sling", "cpu"):
        for a, b in zip(runs["prsim"], runs[name]):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# the slab push: every level over every slab of a device in one launch
# ----------------------------------------------------------------------
def _slabs_on_card(case, n, S, card):
    """The case's graph cut into S node slabs on the card (the last one
    padded past n), d sliced with them (d_offset = the slab's start)."""
    n_pad, n_loc = hp_index.shard_layout(n, S)
    d = np.zeros(n_pad, np.float32)
    d[:n] = case["d"]
    slabs = []
    for s in range(S):
        mine = case["dst"] // n_loc == s
        slabs.append(Slab(
            layout=SpmmLayout.from_edges(case["src"][mine],
                                         case["dst"][mine] - s * n_loc,
                                         case["w"][mine], n_loc, card),
            d=torch.as_tensor(d[s * n_loc:(s + 1) * n_loc], device=card),
            start=s * n_loc, d_offset=s * n_loc))
    return slabs


def _slab_launch(push, rows, us, slabs, tau, n, l_max, **kw):
    """One call of ``push`` (the kernel's wrapper or its plain version)
    over every slab: the (rows, B) node-major result."""
    B = us.shape[0]
    n_rows = sum(sl.layout.n for sl in slabs)
    full = torch.full((n_rows, B), float("nan"), device=us.device)
    push(rows, us, slabs, [full[sl.start:sl.start + sl.layout.n]
                           for sl in slabs], tau, n=n, l_max=l_max,
         n_rows=n_rows, **kw)
    return full


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 4])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_slab_push_matches_plain_on_card(card, B, S):
    """``horner_push_slabs`` over S slabs of a graph whose hubs lie in
    every tier (one above the big tier's 128 in-edges), with pad rows
    past n and duplicate keys, the rows read through the ids from S
    table segments: within ATOL of the plain version, one launch a
    push, equal bits across two launches, and the levels launched one
    at a time (ranges of one sharing the frontier) equal to the one
    launch bit for bit."""
    rng = np.random.default_rng(B * 10 + S)
    n, l_max = 502, 6
    case = table_case(rng, n=n, rows=n, W=40, l_max=l_max, m=6 * n,
                      hubs=(0, 7, 7, 7, 19, 250, 501), dup=True)
    slabs = _slabs_on_card(case, n, S, card)
    keys, vals = (torch.as_tensor(case[k], device=card) for k in ("ku", "xu"))
    n_loc = slabs[0].layout.n
    rows = [(keys[s * n_loc:(s + 1) * n_loc], vals[s * n_loc:(s + 1) * n_loc],
             s * n_loc) for s in range(S)]
    us = torch.as_tensor(np.r_[n - 1, rng.integers(0, n, B - 1)],
                         device=card)
    tau = float(case["tau"])
    before = horner_push_slabs.launches
    got = _slab_launch(horner_push_slabs, rows, us, slabs, tau, n, l_max)
    assert horner_push_slabs.launches == before + 1
    want = _slab_launch(horner_push_slabs_plain, rows, us, slabs, tau, n,
                        l_max)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL, rtol=0)
    assert torch.equal(got, _slab_launch(horner_push_slabs, rows, us, slabs,
                                         tau, n, l_max))
    n_rows = sum(sl.layout.n for sl in slabs)
    ws = torch.full((workspace_numel(n_rows, B, l_max),), float("nan"),
                    device=card)
    outs = [torch.empty((sl.layout.n, B), device=card) for sl in slabs]
    for level in range(l_max, -1, -1):
        horner_push_slabs(rows, us, slabs, outs, tau, n=n, l_max=l_max,
                          hi=level, lo=level, n_rows=n_rows, workspace=ws)
    assert torch.equal(torch.cat(outs), got)
    bf = _slab_launch(horner_push_slabs, rows, us, slabs, tau, n, l_max,
                      bf16_frontier=True)
    bf_plain = _slab_launch(horner_push_slabs_plain, rows, us, slabs, tau,
                            n, l_max, bf16_frontier=True).cpu()
    assert torch.all((bf.cpu() - bf_plain).abs() <= 0.01 * bf_plain + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("B", [8, 9])
def test_sharded_push_matches_the_persistent_push_on_card(card, S, B):
    """The whole push over S slabs on one card, from fetched rows, on the
    kernel (one launch) and on the plain version, against the
    single-device persistent push on the same rows."""
    rng = np.random.default_rng(S * 10 + B)
    n, l_max = 500, 6
    case = table_case(rng, n=n, rows=200, W=40, l_max=l_max, m=6 * n,
                      hubs=(0, 7, 19, 250))
    keys, vals, d = (torch.as_tensor(case[k], device=card)
                     for k in ("ku", "xu", "d"))
    us = torch.as_tensor(rng.integers(0, 200, B), device=card)
    tau = float(case["tau"])
    slabs = _slabs_on_card(case, n, S, card)
    outs = {}
    for backend in ("kernel", "plain"):
        before = horner_push_slabs.launches
        got = slab_horner_push(keys[us], vals[us], slabs, tau, n=n,
                               l_max=l_max, backend=backend)
        outs[backend] = torch.cat(got)[:n].t().cpu().numpy()
        assert horner_push_slabs.launches - before == (
            1 if backend == "kernel" else 0)
    lay = SpmmLayout.from_edges(case["src"], case["dst"], case["w"], n, card)
    whole = horner_push_rows(keys, vals, d, us, lay, tau,
                             l_max=l_max).cpu().numpy()
    np.testing.assert_allclose(outs["kernel"], outs["plain"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(outs["kernel"], whole, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_slab_push_at_the_enron_size_on_card(card, enron_case):
    """Four slabs of the Enron regime at B = 8: the sharded push, one
    launch, against the persistent push."""
    case, n, l_max = enron_case
    keys, vals, d = (torch.as_tensor(case[k], device=card)
                     for k in ("ku", "xu", "d"))
    us = torch.arange(8, device=card)
    tau = float(case["tau"])
    before = horner_push_slabs.launches
    got = torch.cat(slab_horner_push(keys[us], vals[us],
                                     _slabs_on_card(case, n, 4, card), tau,
                                     n=n, l_max=l_max, backend="kernel"))
    assert horner_push_slabs.launches == before + 1
    lay = SpmmLayout.from_edges(case["src"], case["dst"], case["w"], n, card)
    whole = horner_push_rows(keys, vals, d, us, lay, tau, l_max=l_max)
    np.testing.assert_allclose(got[:n].t().cpu().numpy(),
                               whole.cpu().numpy(), atol=ATOL, rtol=0)


def _sharded(card, devices):
    from repro_torch.core import build, shard_query
    g = generators.barabasi_albert(300, 4, seed=3, directed=False)
    idx = build.build_index(g, eps=0.1, exact_d=True, device=card)
    return g, idx, shard_query.shard_index(
        idx, g, shard_query.serving_mesh(len(devices), devices=devices))


@pytest.mark.cuda
def test_sharded_index_is_one_launch_a_push_on_card(card):
    """A ShardedIndex with every shard on the card: a single-source and
    a top-k batch are one ``horner_push_slabs`` launch each (the rows
    read from the shards' tables, no row fetch, no persistent push),
    within ATOL of the one-device answers."""
    from repro_torch.core import shard_query
    from repro_torch.core.single_source import single_source_device
    g, idx, si = _sharded(card, [card] * 4)
    us = np.arange(0, 300, 37, dtype=np.int32)
    launches = (horner_push_slabs.launches, horner_push_rows.launches)
    got = shard_query.sharded_single_source(si, us)
    assert horner_push_slabs.launches == launches[0] + 1
    shard_query.sharded_topk(si, us, 10)
    assert horner_push_slabs.launches == launches[0] + 2
    assert horner_push_rows.launches == launches[1]
    np.testing.assert_allclose(got, single_source_device(idx, g, us,
                                                         device=card),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_mixed_mesh_runs_the_exchange_on_card(card):
    """A mesh of two shards on the card and two on the CPU takes the
    route of several devices -- one launch a level on the card, the
    plain version on the CPU, the frontier exchanged between them --
    within ATOL of every shard on the card; its top-k, the merge of each
    slab's candidates across devices, within ATOL of the one-device
    top-k, ids equal outside near-ties, at k below and above n_loc."""
    from repro_torch.core import shard_query
    g, idx, one = _sharded(card, [card] * 4)
    *_, mixed = _sharded(card, [card, card, "cpu", "cpu"])
    us = np.arange(3, 300, 41, dtype=np.int32)
    before = horner_push_slabs.launches
    got = shard_query.sharded_single_source(mixed, us)
    assert horner_push_slabs.launches > before + 1
    dense = shard_query.sharded_single_source(one, us)
    np.testing.assert_allclose(got, dense, atol=ATOL, rtol=0)
    rows = np.arange(len(us))[:, None]
    for k in (10, one.n_loc + 5):
        mv, mi = shard_query.sharded_topk(mixed, us, k)
        ov, oi = shard_query.sharded_topk(one, us, k)
        np.testing.assert_allclose(mv, ov, atol=ATOL, rtol=0)
        np.testing.assert_allclose(dense[rows, mi], dense[rows, oi],
                                   atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_slab_push_refuses_above_the_cap_on_card(card):
    lay = SpmmLayout.from_edges([0], [0], [0.5], 1, card)
    many = [Slab(layout=lay, d=torch.ones(1, device=card), start=i,
                 d_offset=i) for i in range(MAX_SLABS + 1)]
    keys = torch.zeros((2, 4), dtype=torch.int32, device=card)
    us = torch.arange(2, device=card)
    before = horner_push_slabs.launches
    with pytest.raises(ValueError, match=f"1 to {MAX_SLABS} slabs"):
        horner_push_slabs([(keys, keys.float(), 0)], us, many,
                          [torch.empty((1, 2), device=card) for _ in many],
                          0.0, n=MAX_SLABS + 1, l_max=2)
    assert horner_push_slabs.launches == before


@pytest.mark.cuda
def test_slab_push_raises_without_library_on_card(card, monkeypatch,
                                                  tmp_path):
    """With no nvcc and no built library the slab push raises on a CUDA
    tensor, and so does a sharded index on the card: no plain
    fallback."""
    from repro_torch.core import shard_query
    hp_mod = importlib.import_module(
        "repro_torch.kernels.horner_push.horner_push")
    g, idx, si = _sharded(card, [card, card])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(hp_mod, "_launch", [])
    before = horner_push_slabs.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        shard_query.sharded_single_source(si, [0, 5])
    with pytest.raises(RuntimeError, match="nvcc"):
        shard_query.sharded_topk(si, [0, 5], 4)
    assert horner_push_slabs.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_query_pairs_kernel_matches_reference_on_card(card, seed):
    """The kernel-level pair entry through ``hp_join`` on the card
    against its plain twin, and against the batched join."""
    from repro_torch.core import build
    from repro_torch.kernels.hp_join.ops import (query_pairs_kernel,
                                                 query_pairs_reference)
    g = generators.barabasi_albert(300, 3, seed=seed, directed=False)
    idx = build.build_index(g, eps=0.15, seed=seed, device=card)
    rng = np.random.default_rng(seed)
    us = rng.integers(0, g.n, 500).astype(np.int32)
    vs = rng.integers(0, g.n, 500).astype(np.int32)
    before = hp_join.launches
    got = query_pairs_kernel(idx, us, vs)
    assert hp_join.launches == before + 1
    np.testing.assert_allclose(got, query_pairs_reference(idx, us, vs),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, idx.query_pairs(us, vs), atol=ATOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 33, 256])
def test_spmm_entry_matches_reference_on_card(card, f):
    """The kernel-level ``spmm(x, g, w)`` on the card against
    ``spmm_reference``."""
    from repro_torch.graph import csr
    from repro_torch.kernels.spmv_ell.ops import spmm as spmm_entry
    from repro_torch.kernels.spmv_ell.ops import spmm_reference
    g = generators.barabasi_albert(1001, 4, seed=f, directed=False)
    w = csr.normalized_pull_weights(g, 0.7746)
    x = np.random.default_rng(f).normal(size=(g.n, f)).astype(np.float32)
    before = spmm.launches
    got = spmm_entry(x, g, w)
    assert spmm.launches == before + 1 and got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(),
                               spmm_reference(x, g, w).cpu().numpy(),
                               atol=ATOL, rtol=0)


# ------------------------------------------------------------ LM stack

LM_ARCHS = ("smollm-135m", "gemma3-1b", "qwen3-14b", "mixtral-8x22b",
            "llama4-scout-17b-a16e")
BF16_ULP = 2.0 ** -7   # of max |out|: bf16's spacing at a significand of 1
LM_TOL = {torch.float32: (ATOL, ATOL),          # (outputs, gradients)
          torch.bfloat16: (4 * BF16_ULP, 8 * BF16_ULP)}


def _lm_model(arch, dtype=torch.float32):
    """(config, CPU model, its copy, tokens, targets): the smoke LM with
    wq / wk / wv conditioned (``torch_cases.condition_lm``)."""
    import copy
    import dataclasses

    from repro_torch.configs import base as cfg_base
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(cfg_base.get(arch).smoke(), dtype=dtype)
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    condition_lm(cfg, model)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    return cfg, model, copy.deepcopy(model), tokens, targets


def _lm_outputs(cfg, model, tokens, targets) -> dict:
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import value_and_grad
    with torch.no_grad():
        x, _ = T.forward(cfg, model, tokens)
    loss, grads = value_and_grad(
        lambda p, b: T.lm_loss(cfg, p, b["tokens"], b["targets"]), model,
        {"tokens": tokens, "targets": targets})
    return {"x": x, "loss": loss, **grads}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_and_loss_grads_on_card_equal_cpu(card, arch, dtype,
                                                     monkeypatch):
    """The smoke LM (TF32 off): forward, ``lm_loss`` and every leaf's
    gradient on the card against the CPU, within LM_TOL of max |out|:
    float32 ATOL (reduction order), bf16 4 ulps for outputs and 8 for
    gradients (the yardstick tests/test_torch_lm.py holds the port to
    against the reference in bf16)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, cpu_model, card_model, tokens, targets = _lm_model(arch, dtype)
    card_model.to(card)
    ref = _lm_outputs(cfg, cpu_model, tokens, targets)
    got = _lm_outputs(cfg, card_model, tokens, targets)
    assert got["x"].device.type == card.type and got.keys() == ref.keys()
    assert got["x"].dtype == dtype
    out_tol, grad_tol = LM_TOL[dtype]
    for n, r in ref.items():
        err, tol = _rel(got[n], r), out_tol if n in ("x", "loss") else grad_tol
        assert err <= tol, (n, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_on_card_equal_cpu(card, arch, dtype,
                                                 monkeypatch):
    """``prefill`` over 16 tokens, the cache padded by 4 and three
    ``decode_step``s (fixed tokens) on the card against the CPU (TF32
    off): logits and cache contents within LM_TOL's output tolerance,
    the card's cache written in place."""
    from repro_torch.models import transformer as T
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, cpu_model, card_model, tokens, _ = _lm_model(arch, dtype)
    card_model.to(card)

    def run(model):
        logits, cache = T.prefill(cfg, model, tokens)
        out = {"prefill": logits}
        cache = T.pad_cache(cache, 20)
        k = cache["k"]
        nxt = torch.as_tensor(np.asarray([1, 2]), device=logits.device)
        for i in range(3):
            logits, cache = T.decode_step(cfg, model, cache, nxt)
            out[f"decode{i}"] = logits
            nxt = (nxt * 7 + i) % cfg.vocab
        out["k"], out["v"] = cache["k"], cache["v"]
        assert cache["len"] == 19 and cache["k"] is k
        assert k.dtype == dtype
        return out

    ref, got = run(cpu_model), run(card_model)
    assert got["k"].device.type == card.type
    for n, r in ref.items():
        err = _rel(got[n], r)
        assert err <= LM_TOL[dtype][0], (n, err)


# ------------------------------------------------------ sharded models


def _mesh_of(device, shape, axes=("data",)):
    from repro_torch.launch.mesh import make_debug_mesh
    return make_debug_mesh(shape, axes,
                           devices=[device] * int(np.prod(shape)))


def _gcn_case(device):
    """(config, model on ``device``, the 4-shard batch) of the smoke GCN
    on BA(400)."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.models import gnn as G
    from repro_torch.models.gnn_sharded import build_sharded_gcn_batch
    cfg = cfg_base.get("gcn-cora").smoke()
    g = generators.barabasi_albert(400, 3, seed=1, directed=False)
    model = G.init_params(cfg, torch.Generator().manual_seed(2)).to(device)
    return cfg, model, build_sharded_gcn_batch(g, cfg.d_in, cfg.n_classes,
                                               4, seed=1)


@pytest.mark.cuda
def test_sharded_gcn_on_four_card_shards_equals_cpu(card, monkeypatch):
    """``gcn_loss_sharded`` on four shards of ``cuda:0`` against four
    CPU shards (TF32 off): the loss and every leaf's gradient within
    ATOL of max |ref|, the loss on the card."""
    from repro_torch.launch.sharding import use_mesh_rules
    from repro_torch.models.gnn_sharded import gcn_loss_sharded
    from repro_torch.train.trainer import value_and_grad
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    out = {}
    for dev in ("cpu", card):
        cfg, model, batch = _gcn_case(dev)
        with use_mesh_rules(_mesh_of(dev, (4,))):
            loss, grads = value_and_grad(
                lambda p, b: gcn_loss_sharded(cfg, p, b), model, batch)
        out[str(dev)] = {"loss": loss, **grads}
    ref, got = out["cpu"], out[str(card)]
    assert got["loss"].device.type == card.type
    for n, r in ref.items():
        assert _rel(got[n], r) <= ATOL, n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_mesh_branch_on_card_equals_cpu(card, arch, dtype, monkeypatch):
    """The smoke MoE LM's ``lm_loss`` under a ("data",) = 4 mesh of
    ``cuda:0`` against the same mesh of the CPU (TF32 off): the loss and
    every leaf's gradient within LM_TOL, as the ``lm`` cases."""
    from repro_torch.launch.sharding import use_mesh_rules
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, cpu_model, card_model, tokens, targets = _lm_model(arch, dtype)
    card_model.to(card)
    out = {}
    for dev, model in (("cpu", cpu_model), (card, card_model)):
        with use_mesh_rules(_mesh_of(dev, (4,))):
            out[str(dev)] = _lm_outputs(cfg, model, tokens, targets)
    ref, got = out["cpu"], out[str(card)]
    out_tol, grad_tol = LM_TOL[dtype]
    for n, r in ref.items():
        err, tol = _rel(got[n], r), out_tol if n in ("x", "loss") else grad_tol
        assert err <= tol, (n, err, tol)


@pytest.mark.cuda
def test_elastic_restore_on_card_gathers_equal_bits(card, tmp_path):
    """A GCN trained two sharded steps on four ``cuda:0`` shards, saved,
    and restored under the two-shard mesh ``remesh`` plans: every
    parameter and AdamW leaf lies on the card in its pieces and gathers
    back to the saved bits."""
    from repro_torch.launch.sharding import (NamedSharding, tree_paths,
                                             tree_shardings, use_mesh_rules)
    from repro_torch.models import gnn as G
    from repro_torch.models.gnn_sharded import gcn_loss_sharded
    from repro_torch.optim.adamw import AdamW, AdamWState
    from repro_torch.train import checkpoint, elastic
    from repro_torch.train.trainer import value_and_grad
    cfg, model, batch = _gcn_case(card)
    opt = AdamW(lr=1e-2)
    state = opt.init(model)
    with use_mesh_rules(_mesh_of(card, (4,))):
        for _ in range(2):
            _, grads = value_and_grad(
                lambda p, b: gcn_loss_sharded(cfg, p, b), model, batch)
            model, state = opt.update(grads, state, model)
    checkpoint.save(str(tmp_path), 2, model, state)
    mesh = elastic.make_mesh_from_plan(elastic.remesh(2, 1, 4, 4),
                                       devices=[card] * 2)
    like = G.init_params(cfg, torch.Generator().manual_seed(7)).to(card)
    ps = tree_shardings(like, mesh)
    rp, ro, _ = checkpoint.restore(
        str(tmp_path), 2, like, opt.init(like), mesh, ps,
        AdamWState(step=NamedSharding(mesh, ()), m=ps, v=ps))
    got = {**rp, **dict(tree_paths(ro))}
    want = dict(tree_paths(model) + tree_paths(state))
    assert got.keys() == want.keys()
    for n, st in got.items():
        assert all(p.device.type == card.type for p in st.pieces.values())
        assert torch.equal(st.gather(), want[n].detach()), n


# the cells of chip_smoke.py's phase 3n: the CIN kernel, its gradient
# kernels, a GNN with no kernel, and the sharded push
CELLS_3N = [("xdeepfm", "serve_p99"), ("xdeepfm", "train_batch"),
            ("gcn-cora", "full_graph_sm"), ("sling-serve", "serve_batch")]


def _chip_smoke():
    """``chip_smoke.py`` as a module (its helpers build a cell's real
    inputs)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sling_host(seed: int = 0) -> dict:
    """A small SLING "index" for the sling-serve cell's inputs: a
    2,000-node graph and sorted random keys of 13 levels, two PAD slots
    a row."""
    from repro_torch.core.hp_index import INT32_PAD_KEY
    g = generators.barabasi_albert(2000, 4, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    keys = torch.sort(torch.randint(0, 13 * 2000, (2000, 8),
                                    generator=gen, dtype=torch.int32),
                      dim=1).values
    keys[:, -2:] = INT32_PAD_KEY
    return {"g": g, "keys": keys, "vals": torch.rand((2000, 8),
                                                     generator=gen),
            "d": torch.rand(2000, generator=gen)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape", CELLS_3N)
def test_cell_predicted_equals_measured_on_card(card, arch, shape):
    """A cell on the card's (1, 1) mesh: the dry run's argument bytes
    equal the placed real arguments', and its port kernels' calls equal
    the launch counters over one real step."""
    from repro_torch.kernels import cin as kcin
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import make_cell
    cs = _chip_smoke()
    mesh = make_debug_mesh((1, 1), ("data", "model"), devices=[card])
    rec = dryrun.run_cell(arch, shape, verbose=False, mesh=mesh)
    cell = make_cell(arch, shape, mesh)
    if arch == "sling-serve":
        args, _ = cs.sling_cell_inputs(cell, _sling_host(), card, 0)
    else:
        args = cs.cell_inputs(cell, arch, shape, card, 0)
    placed = cell.place(args)
    assert rec["bytes_per_device"]["argument"] == cs.placed_bytes(placed)
    counters = {"horner_push_rows": horner_push_rows,
                "horner_push_slabs": horner_push_slabs,
                "cin_layer": kcin.cin_layer, "cin_grad_xk": cin_grad_xk,
                "cin_grad_x0": cin_grad_x0, "cin_grad_w": cin_grad_w,
                "hp_join": hp_join, "spmm": spmm}
    for fn in counters.values():
        fn.launches = 0
    cell.jitted()(*placed)
    torch.cuda.synchronize()
    assert {k: fn.launches for k, fn in counters.items()
            if fn.launches} == rec["kernels"]
