"""The CIN kernel's precision scheme (3xTF32), checked on the CPU.

The Hopper kernel (``csrc/cin.cu``) runs the layer on the tensor cores
in TF32, with both operands split into two TF32 parts and three
products summed in float32. What can be checked without the card: the
wrapper's weight split, the depth-split rule, and a float64 NumPy
emulation of the three products at full width, which holds the port's
bound of 2e-5 of max |out| where a single TF32 pass does not.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.cin.cin import (CARD_SMS, depth_split,
                                         split_weights, tf32_round)

TOL_CIN = 2e-5          # chip_smoke.TOL_CIN, relative to max |out|
LOW13 = 0x1FFF


def np_tf32(x):
    """float32 -> TF32 to nearest, ties away: the kernel's cvt.rna."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _w(seed, hp, h, m):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(hp, h, m)) / np.sqrt(h * m)).astype(np.float32)


@pytest.mark.parametrize("shape", [(200, 200, 39), (200, 39, 39),
                                   (65, 5, 3), (6, 4, 4)], ids=str)
def test_split_weights_parts_are_tf32_and_sum_to_w(shape):
    W = _w(sum(shape), *shape)
    hp, h, m = shape
    K, Kp = h * m, -(-h * m // 4) * 4
    w2 = split_weights(torch.as_tensor(W))
    assert w2.shape == (2, hp, Kp) and w2.dtype == torch.float32
    bits = w2.view(torch.int32)
    assert int((bits & LOW13).abs().max()) == 0     # both parts TF32-exact
    assert not bool(w2[:, :, K:].any())
    hi, lo = (w2[i, :, :K].numpy().astype(np.float64) for i in (0, 1))
    w = W.reshape(hp, K).astype(np.float64)
    # W_lo keeps 11 of the 13 bits below W_hi: W to ~2^-22 relative
    assert np.all(np.abs(hi + lo - w) <= 2.0 ** -22 * np.abs(w))
    np.testing.assert_array_equal(hi, np_tf32(W.reshape(hp, K)))
    np.testing.assert_array_equal(lo, np_tf32(W.reshape(hp, K)
                                              - np_tf32(W.reshape(hp, K))))


def test_tf32_round_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)             # TF32 spacing at 1
    x = np.array([one + ulp / 2, one + ulp / 2 - np.float32(2.0 ** -23),
                  -(one + ulp / 2), one + ulp * 1.5], np.float32)
    got = tf32_round(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(
        got, np.array([one + ulp, one, -(one + ulp), one + 2 * ulp],
                      np.float32))


@pytest.mark.parametrize("rows,hp,K,want", [
    (5120, 200, 7800, 3),           # serve_p99: 40 tiles x 3 chunks
    (5120, 200, 1521, 3),
    (10_000_000, 200, 7800, 1),     # retrieval_cand: the grid is full
    (160, 200, 1521, 6),            # 2 tiles; 48 k-tiles keep 8 each
    (52, 6, 16, 1),                 # one k-tile: nothing to split
    (200_000, 200, 1521, 1),        # 1,563 tiles
])
def test_depth_split_fills_one_wave(rows, hp, K, want):
    s = depth_split(rows, hp, K)
    assert s == want
    tiles = -(-rows // 128) * -(-hp // 200)
    assert s == 1 or tiles * s <= CARD_SMS


def _emulate(seed, B, m, h, hp, D):
    """(3xTF32 error, 1xTF32 error), each relative to max |out|, of a
    float64 emulation of the kernel's products against the exact sum."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, m, D)).astype(np.float32)
    xk = rng.normal(size=(B, h, D)).astype(np.float32)
    W = _w(seed + 1, hp, h, m)
    # rows r = (b, d), depth k = (a, j): z[r, k] = xk[b, a, d] * x0[b, j, d]
    z32 = (xk[:, :, None, :] * x0[:, None, :, :]).transpose(0, 3, 1, 2) \
        .reshape(B * D, h * m)                       # float32, as formed
    z64 = (xk[:, :, None, :].astype(np.float64)
           * x0[:, None, :, :]).transpose(0, 3, 1, 2).reshape(B * D, h * m)
    w = W.reshape(hp, h * m).T
    exact = z64 @ w.astype(np.float64)
    z_hi = np_tf32(z32)
    z_lo = np_tf32(z32 - z_hi)
    w_hi = np_tf32(w)
    w_lo = np_tf32(w - w_hi)
    f = np.float64
    three = z_lo.astype(f) @ w_hi.astype(f) + z_hi.astype(f) @ w_lo.astype(f) \
        + z_hi.astype(f) @ w_hi.astype(f)
    one = z_hi.astype(f) @ w_hi.astype(f)
    scale = np.abs(exact).max()
    return (np.abs(three - exact).max() / scale,
            np.abs(one - exact).max() / scale)


def test_three_tf32_products_hold_the_bound_at_full_width():
    """A 200 -> 200 layer of xdeepfm.full() (m = 39, D = 10) at B = 64:
    three TF32 products stay far inside 2e-5 of max |out|; one TF32
    pass misses it, which is why the kernel runs three."""
    three, one = _emulate(3, 64, 39, 200, 200, 10)
    assert three <= TOL_CIN / 20, three
    assert one > TOL_CIN, one
