"""The CIN gradient kernels' layouts and orders, checked on the CPU.

``cin_grad_x0`` runs dx0 as a GEMM over g with xk in its epilogue:

    T[r, j*h8 + a] = sum_i g[r, i] * W[i, a, j]      (3xTF32 wgmma)
    dx0[r, j]      = sum_a xk[r, a] * T[r, j*h8 + a]  (float32 epilogue)

with rows r = b*D + d, h8 = h rounded up to 8, the A operand
``split_grad_rows(g)`` and the B operand ``split_weights_x0(W)``;
``cin_grad_w`` runs dW over the B*D data rows with ``split_grad_t(g)``
as its B operand and z = xk * x0 formed from depth tiles of x0 and xk
that its producer stages in shared memory.

What can be checked without the card: the split operands against
NumPy, bit for bit; a NumPy emulation of the new dx0 order at full width
(TF32 parts, three products a k8 step, the per-k-tile float32
promotion, the epilogue's float32 dots in the kernel's column order and
the quad's shuffle order) against float64; plain mirrors of both
regroupings that walk the kernels' tiles (``x0grad_tiling``'s j-groups
and column tiles, dW's 128-row tiles and their staged x0 / xk rows)
against ``cin_grad_x0_plain`` / ``cin_grad_w_plain`` and ``jax.vjp`` of
one reference einsum layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.cin.cin import (TILE_K, TILE_MAPS, TILE_ROWS,
                                         split_grad_rows, split_grad_t,
                                         split_weights_x0, x0grad_tiling)
from repro_torch.kernels.cin.ref import cin_grad_w_plain, cin_grad_x0_plain

TOL_CIN = 2e-5          # chip_smoke.TOL_CIN, relative to max |grad|


def np_tf32(x):
    """float32 -> TF32 to nearest, ties away: the kernel's cvt.rna."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _case(seed, B, m, h, hp, D):
    """O(1)-scale x0, xk, g and W / sqrt(h*m), float32."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, m, D)).astype(np.float32)
    xk = rng.normal(size=(B, h, D)).astype(np.float32)
    W = (rng.normal(size=(hp, h, m)) / np.sqrt(h * m)).astype(np.float32)
    g = rng.normal(size=(B, hp, D)).astype(np.float32)
    return x0, xk, W, g


def _rows(x):
    """(B, n, D) -> (B*D, n): row r = b*D + d."""
    return x.transpose(0, 2, 1).reshape(-1, x.shape[1])


def _dx0_exact(xk, W, g):
    return np.einsum("bid,iaj,bad->bjd", g.astype(np.float64),
                     W.astype(np.float64), xk.astype(np.float64))


def _vjp(x0, xk, W, g):
    """(dx0, dxk, dW) by jax.vjp of one reference einsum layer."""
    def layer(a, b, w):
        return jnp.einsum("bhfd,ihf->bid", jnp.einsum("bhd,bfd->bhfd", b, a),
                          w)
    _, vjp = jax.vjp(layer, jnp.asarray(x0), jnp.asarray(xk), jnp.asarray(W))
    return [np.asarray(r) for r in vjp(jnp.asarray(g))]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("hp,h,m", [(200, 39, 39), (200, 200, 39),
                                    (70, 17, 5), (13, 450, 3), (9, 1, 1)],
                         ids=str)
def test_split_weights_x0_rows_are_j_h8_plus_a(hp, h, m):
    """Row c = j*h8 + a of each part holds W[:, a, j]'s TF32 part for
    a < h, zeros for h <= a < h8; columns past h' are zero; Kp = h'
    rounded up to 4."""
    W = _case(h, 1, m, h, hp, 1)[2]
    h8 = -(-h // 8) * 8
    wt = split_weights_x0(torch.as_tensor(W)).numpy()
    Kp = -(-hp // 4) * 4
    assert wt.shape == (2, m * h8, Kp)
    want = np.zeros((2, m, h8, Kp), np.float32)
    w = W.transpose(2, 1, 0)                       # (m, h, hp)
    want[0, :, :h, :hp] = np_tf32(w)
    want[1, :, :h, :hp] = np_tf32(w - np_tf32(w))
    np.testing.assert_array_equal(wt, want.reshape(2, m * h8, Kp))
    assert h8 % 8 == 0 and h8 - h < 8


@pytest.mark.parametrize("B,hp,D", [(64, 200, 10), (13, 65, 10),
                                    (3, 7, 3), (1, 1, 1)], ids=str)
@pytest.mark.parametrize("rows_major", [False, True],
                         ids=["dW_transposed", "dx0_by_rows"])
def test_split_grad_layouts(B, hp, D, rows_major):
    """dW's B operand: column r = b*D + d of each part holds g[b, :, d]'s
    TF32 part, the columns past B*D (to Rp, a multiple of 4) zero.
    dx0's A operand: row r holds it, the columns past h' (to Kp) zero."""
    g = _case(B, B, 1, 1, hp, D)[3]
    R = B * D
    want = _rows(g) if rows_major else _rows(g).T
    fn = split_grad_rows if rows_major else split_grad_t
    got = fn(torch.as_tensor(g)).numpy()
    n = want.shape[1]
    assert got.shape == (2, want.shape[0], -(-n // 4) * 4)
    np.testing.assert_array_equal(got[0, :, :n], np_tf32(want))
    np.testing.assert_array_equal(got[1, :, :n],
                                  np_tf32(want - np_tf32(want)))
    assert not got[:, :, n:].any()
    assert want.shape == ((R, hp) if rows_major else (hp, R))


def _dx0_by_tiles(xk, T, m, h):
    """dx0 (B*D, m) from T (B*D, m*h8) and xk (B*D, h) in the kernel's
    order: units (j-group, column tile) of ``x0grad_tiling``, groups of
    8 columns, each quad thread q's float32 products of columns 2q and
    2q + 1 added in column order, then ((q0 + q1) + (q2 + q3)). Every
    (r, j) is written once."""
    h8, J, n_sub, n_ct = x0grad_tiling(m, h)
    R = T.shape[0]
    N = m * h8
    xk = xk.astype(np.float32)
    out = np.full((R, m), np.nan, np.float32)
    for cg in range(n_ct):
        j0 = cg * J
        jend = min(j0 + J, m)
        run = np.zeros((4, R), np.float32)
        jcur = -1

        def flush():
            out[:, jcur] = (run[0] + run[1]) + (run[2] + run[3])
            run[:] = 0
        for sub in range(n_sub):
            col0 = j0 * h8 + sub * TILE_MAPS
            for jn in range(TILE_MAPS // 8):
                c8 = col0 + 8 * jn
                j, a = divmod(c8, h8)
                if j >= jend:
                    continue
                if j != jcur:
                    if jcur >= 0:
                        assert np.isnan(out[:, jcur]).all()
                        flush()
                    jcur = j
                for q in range(4):
                    for e in range(2):
                        c, aa = c8 + 2 * q + e, a + 2 * q + e
                        t = T[:, c] if c < N else np.zeros(R, np.float32)
                        x = xk[:, aa] if aa < h else np.zeros(R, np.float32)
                        run[q] = run[q] + t * x
        flush()
    assert not np.isnan(out).any()
    return out


def _T(g2, wt, three=True):
    """T = g @ Wt^T (B*D, m*h8) in the kernel's order from the TF32 parts
    g2 of g (``split_grad_rows``) and wt of W: float64 sums of each
    32-deep k-tile's products (three a k8 step, or the hi*hi one alone),
    rounded to float32 and promoted into float32 running sums."""
    f = np.float64
    g_hi, g_lo = g2
    w_hi, w_lo = (wt[p].T.astype(f) for p in (0, 1))
    acc = np.zeros((g_hi.shape[0], wt.shape[1]), np.float32)
    for k0 in range(0, g_hi.shape[1], TILE_K):
        s = slice(k0, k0 + TILE_K)
        tile = g_hi[:, s].astype(f) @ w_hi[s]
        if three:
            tile += g_lo[:, s].astype(f) @ w_hi[s] + \
                g_hi[:, s].astype(f) @ w_lo[s]
        acc = acc + tile.astype(np.float32)
    return acc


@pytest.mark.parametrize("shape", [(64, 39, 200, 200, 10),
                                   (64, 39, 39, 200, 10),
                                   (16, 5, 450, 70, 10)], ids=str)
def test_dx0_order_holds_the_bound(shape):
    """The new dx0 order (B, m, h, h', D): xDeepFM's 200 -> 200 layer
    and layer 1 at B = 64, and a j wider than one column tile. Three
    TF32 products with per-k-tile promotion and the float32 epilogue
    stay within TOL_CIN / 20 of float64; a single TF32 pass over the
    same depth misses TOL_CIN at full width."""
    B, m, h, hp, D = shape
    x0, xk, W, g = _case(sum(shape), *shape)
    wt = split_weights_x0(torch.as_tensor(W)).numpy()
    g2 = split_grad_rows(torch.as_tensor(g)).numpy()
    exact = _rows(_dx0_exact(xk, W, g))
    errs = []
    for three in (True, False):
        got = _dx0_by_tiles(_rows(xk), _T(g2, wt, three), m, h)
        errs.append(_rel(got, exact))
    assert errs[0] <= TOL_CIN / 20, errs
    if shape == (64, 39, 200, 200, 10):
        assert errs[1] > TOL_CIN, errs


@pytest.mark.parametrize("shape", [(6, 4, 5, 3, 2), (5, 39, 39, 200, 10),
                                   (3, 7, 17, 65, 3), (2, 3, 201, 9, 4),
                                   (4, 1, 1, 2, 3)], ids=str)
def test_dx0_regrouping_equals_plain_and_jax_vjp(shape):
    """GEMM over g, then the epilogue over the kernel's tiles, in float64
    parts: equal to ``cin_grad_x0_plain`` and to ``jax.vjp`` of one
    reference einsum layer within float32 order."""
    B, m, h, hp, D = shape
    x0, xk, W, g = _case(sum(shape) + 1, *shape)
    h8 = -(-h // 8) * 8
    wt = np.zeros((m, h8, hp))
    wt[:, :h] = W.transpose(2, 1, 0)
    T = _rows(g).astype(np.float64) @ wt.reshape(m * h8, hp).T
    got = _dx0_by_tiles(_rows(xk).astype(np.float64), T, m, h)
    got = got.reshape(B, D, m).transpose(0, 2, 1)
    plain = cin_grad_x0_plain(*(torch.as_tensor(a) for a in (xk, W, g)))
    jx = _vjp(x0, xk, W, g)[0]
    exact = _dx0_exact(xk, W, g)
    for want in (plain.numpy(), jx):
        assert _rel(got, want) <= 1e-5
    assert _rel(got, exact) <= 1e-6


def _wgrad_stage(m, h, row0, M):
    """The staged rows of dW's depth tile for the row tile at row0 (as
    csrc/cin.cu's produce_wgrad stages them): x0 rows j (all m, or from
    j0 = row0 mod m, 128 of them, past m = 128), then xk rows a0.. of the
    tile's rows k = a*m + j; and each row k's (x0 row, xk row) in it."""
    wide = m > TILE_ROWS
    nj = TILE_ROWS if wide else m
    a0 = row0 // m
    last = min(row0 + TILE_ROWS, M) - 1
    j0 = row0 - a0 * m
    x0_rows = [(j0 + s) % m if wide else s for s in range(nj)]
    xk_rows = list(range(a0, last // m + 1))
    slots = {}
    for k in range(row0, last + 1):
        a, j = divmod(k, m)
        slots[k] = (k - row0 if wide else j, nj + a - a0)
    cap = nj + min(h, (TILE_ROWS - 1) // m + 2)
    return x0_rows, xk_rows, slots, cap


@pytest.mark.parametrize("shape", [(6, 4, 5, 3, 2), (5, 39, 39, 200, 10),
                                   (5, 39, 200, 30, 10), (3, 130, 17, 9, 7),
                                   (4, 1, 200, 5, 3), (3, 2, 70, 4, 5)],
                         ids=str)
def test_dw_regrouping_equals_plain_and_jax_vjp(shape):
    """dW over 128-row tiles of k = a*m + j and 32-row depth tiles, with
    z formed from the staged x0 and xk rows and the B operand read from
    ``split_grad_t``'s layout (hi + lo, float64): every staged slot holds
    the row its k needs, within the kernel's stage_rows, and the result
    equals ``cin_grad_w_plain`` and ``jax.vjp`` within float32 order."""
    B, m, h, hp, D = shape
    x0, xk, W, g = _case(sum(shape) + 2, *shape)
    R, K = B * D, h * m
    gt = split_grad_t(torch.as_tensor(g)).numpy().astype(np.float64)
    gt = (gt[0] + gt[1])[:, :R]                    # (hp, R)
    x0r, xkr = _rows(x0).astype(np.float64), _rows(xk).astype(np.float64)
    dw = np.zeros((hp, K))
    for row0 in range(0, K, TILE_ROWS):
        x0_rows, xk_rows, slots, cap = _wgrad_stage(m, h, row0, K)
        assert len(x0_rows) + len(xk_rows) <= cap
        for r0 in range(0, R, TILE_K):
            rs = slice(r0, min(r0 + TILE_K, R))
            staged = np.concatenate([x0r[rs][:, x0_rows],
                                     xkr[rs][:, xk_rows]], axis=1).T
            for k, (xs, ks) in slots.items():
                a, j = divmod(k, m)
                assert x0_rows[xs] == j and xk_rows[ks - len(x0_rows)] == a
                dw[:, k] += gt[:, rs] @ (staged[ks] * staged[xs])
    got = dw.reshape(hp, h, m)
    plain = cin_grad_w_plain(*(torch.as_tensor(a) for a in (x0, xk, g)))
    jx = _vjp(x0, xk, W, g)[2]
    for want in (plain.numpy(), jx):
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("m,h,want", [(39, 200, (200, 1, 1, 39)),
                                      (39, 39, (40, 5, 1, 8)),
                                      (39, 17, (24, 8, 1, 5)),
                                      (39, 201, (208, 1, 2, 39)),
                                      (2, 450, (456, 1, 3, 2)),
                                      (1, 1, (8, 25, 1, 1))])
def test_x0grad_tiling(m, h, want):
    """(h8, J, n_sub, units a row tile): J whole j in a 200-column tile,
    or one j over n_sub tiles; never both."""
    got = x0grad_tiling(m, h)
    assert got == want
    h8, J, n_sub, n_ct = got
    assert (J * h8 <= TILE_MAPS and n_sub == 1) or \
        (J == 1 and (n_sub - 1) * TILE_MAPS < h8 <= n_sub * TILE_MAPS)
    assert n_ct * J >= m > (n_ct - 1) * J
