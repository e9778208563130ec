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
from repro_torch.kernels.cin import (cin_forward, cin_forward_reference,
                                     cin_layer, cin_layer_ref)
from repro_torch.kernels.cin.cin import (depth_split, split_weights,
                                         split_weights_on_card)
from repro_torch.graph import generators
from repro_torch.kernels.horner_push import (horner_push_rows,
                                             horner_push_rows_plain,
                                             persistent_grid,
                                             workspace_numel)
from repro_torch.kernels.hp_join import hp_join, hp_join_plain
from repro_torch.kernels.spmv_ell import (HEAVY_DEGREE, SpmmLayout,
                                          segment_live, spmm, spmm_plain)
from torch_cases import JOIN_CASES, join_rows, port_join, table_case

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
def test_cin_refuses_tensors_that_record_a_gradient(card):
    """The kernel has no backward: rather than return an output cut off
    from autograd, the wrapper raises; under no_grad it launches."""
    x0, xk, W = (torch.as_tensor(a, device=card)
                 for a in _cin_case(1, 8, 4, 4, 6, 3))
    W.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        cin_layer(x0, xk, W)
    with torch.no_grad():
        assert cin_layer(x0, xk, W).shape == (8, 6, 3)


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
