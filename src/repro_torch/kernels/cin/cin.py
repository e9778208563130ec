"""One CIN layer: the Hopper kernel's wrapper and the backend switch.

Replaces the TPU kernel ``src/repro/kernels/cin/cin.py`` (``_kernel`` /
``cin_layer``). Both versions compute, for x0 (B, m, D), xk (B, h, D)
and W (h', h, m), all float32,

    out[b, i, d] = sum_{a, j} W[i, a, j] * xk[b, a, d] * x0[b, j, d]

The kernel (``csrc/cin.cu``) runs the layer as a GEMM on Hopper's
tensor cores (``wgmma``, TF32): rows r = b*D + d, depth k = a*m + j,
columns i, with the A operand z[r, k] = xk[r, a] * x0[r, j] formed in
shared memory on the fly, so the (B, h, m, D) product never reaches
device memory. It is bound by operations: 3 x 2*B*D*h*m*h' at the
card's TF32 rate, because each k-step runs three TF32 products
(3xTF32): with a = a_hi + a_lo and b = b_hi + b_lo, each part exactly
TF32, it sums a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in float32. One TF32
pass would keep 10 mantissa bits and miss the port's bound of 2e-5 of
max |out| at K = h*m = 7,800; three keep float32-level accuracy.

Each k-tile's products go into fresh tensor-core accumulators that are
then added to the running float32 sums (the tensor cores' own sums
over all of K = 7,800 miss the bound). A block owns 128 rows x 200
maps: two warpgroups run the ``wgmma`` while a third forms z and
splits it, and TMA brings W's two parts, through a ring of two
shared-memory stages of 32 k under mbarriers (185 KB of shared memory
at m = 39; see the source's note). The wrapper splits W into its two
TF32 parts on every call (a small kernel, ``cin_split``, whose plain
version is :func:`split_weights`) and picks the depth split s from the
shapes alone (:func:`depth_split`): a batch with fewer 128 x 200 tiles
than the card has SMs splits its depth into s chunks, whose partial
sums a second pass adds in chunk order (no atomics, so two calls give
the same bits); a large one runs a persistent grid.

The gradient. The reference trains through ``jax.grad`` of the einsum
form (``repro/models/recsys.py:95``); its Pallas kernel has no
backward. Here :class:`CinLayer` is the layer's
``torch.autograd.Function``: when autograd records a graph through
:func:`cin_layer`, its backward runs three wrappers, each counting its
launches:

* :func:`cin_grad_xk`: the layer kernel on x0, g and W permuted;
* :func:`cin_grad_x0`: the contraction regrouped as a GEMM over g with
  xk in the epilogue, T[r, j*h8 + a] = sum_i g[r, i] * W[i, a, j], then
  dx0[r, j] = sum_a xk[r, a] * T[r, j*h8 + a] (``cin_grad_x0_launch``,
  rows r = b*D + d, depth h'). Both operands are split by pre-passes
  and brought by TMA: A is g by rows (:func:`split_grad_rows`, 1.05 GB
  for the call at B = 65,536), B is W permuted with h rounded up to h8,
  a multiple of 8 (:func:`split_weights_x0`); a column tile holds
  J = 200 // h8 whole j (:func:`x0grad_tiling`). The depth is h' (200),
  not h*h' (40,000), and no column of the tile is padding;
* :func:`cin_grad_w`: ``cin_wgrad``, the GEMM dW[i, k] = sum_r g[r, i] *
  z[r, k] with rows k = a*m + j and depth the B*D data rows. A pre-pass
  (:func:`split_grad_t`) writes g transposed to (h', B*D) in its two
  TF32 parts, so the kernel brings it by TMA (1.05 GB for the call at
  B = 65,536); its producer forms z from x0 and xk depth tiles staged
  in shared memory by coalesced copies.

Each is bound by operations, 3 x 2*B*D*h*m*h' at the TF32 rate; on
the card what holds dx0 back is its epilogue's xk reads and the
operands' traffic, and dW its producer's work a depth tile (copies,
product, split). Shared memory: dx0 the two 82 KB stages alone
(165 KB), dW the stages and a ring of 3 depth tiles of x0 and xk rows
(18.6 KB at m = 39, at most 55 KB). On a CUDA tensor they launch or
raise; on a CPU tensor they run the plain formulas of ``ref.py``.
Under ``no_grad`` / ``inference_mode`` :func:`cin_layer` launches the
layer kernel directly, as serving always has.

:func:`cin_layer_cost` and :func:`cin_grad_cost` count a call's work
(the pre-passes and the W split are inside it, as in the times). On
``FakeTensor`` inputs (the dry run) each wrapper makes its output empty
and records that cost (``kernels/cost.py``) instead of launching.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.cin.ref import (cin_grad_w_plain, cin_grad_x0_plain,
                                         cin_grad_xk_plain, cin_layer_ref)

CIN_BACKENDS = ("auto", "plain")
TILE_ROWS, TILE_MAPS, TILE_K = 128, 200, 32   # csrc/cin.cu kBM, kBN, kBK
CARD_SMS = 132         # the H100 SXM's SMs: the split targets one wave
MIN_CHUNK_TILES = 8    # k-tiles a depth chunk keeps at least
_launch = {}   # the bound C functions by name, filled on first launch


def _launcher() -> dict:
    """The bound C functions of the built library, keyed by their names
    without ``_launch``: cin_split, cin, cin_wgrad, cin_split_wx0,
    cin_grad_x0, cin_split_gt, cin_split_g."""
    if not _launch:
        lib = _build.load("cin")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        layer = [ptr] * 5 + [i64] + [i32] * 5 + [ptr]
        grad_split = [ptr, ptr, i64, i32, i32, ptr]
        for name, argtypes in (
                ("cin_split", [ptr, ptr, i32, i32, ptr]),
                ("cin", layer),
                ("cin_wgrad", layer),
                ("cin_split_wx0", [ptr, ptr, i32, i32, i32, ptr]),
                ("cin_grad_x0", [ptr] * 4 + [i64] + [i32] * 6 + [ptr]),
                ("cin_split_gt", grad_split),
                ("cin_split_g", grad_split)):
            fn = getattr(lib, name + "_launch")
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _launch[name] = fn
    return _launch


def _check(x0, xk, W) -> None:
    if x0.dim() != 3 or xk.dim() != 3 or W.dim() != 3 or \
            xk.shape[0] != x0.shape[0] or xk.shape[2] != x0.shape[2] or \
            W.shape[1:] != (xk.shape[1], x0.shape[1]):
        raise ValueError(f"cin shapes: x0 {tuple(x0.shape)} (B, m, D), xk "
                         f"{tuple(xk.shape)} (B, h, D), W {tuple(W.shape)} "
                         f"(h', h, m)")
    if any(t.dtype != torch.float32 for t in (x0, xk, W)):
        raise TypeError("cin takes float32 x0, xk and W")
    if len({t.device for t in (x0, xk, W)}) != 1:
        raise ValueError("cin arguments must share one device")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: the low 13 bits of
    the result are 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_weights(W: torch.Tensor) -> torch.Tensor:
    """W (h', h, m) float32 -> (2, h', Kp) float32 with [0] = W_hi =
    tf32_round(W), [1] = W_lo = tf32_round(W - W_hi), flattened over
    K = h*m and padded with zeros to Kp, the next multiple of 4 (a row
    stride of whole 16 bytes, as the kernel's TMA copies need). W_hi +
    W_lo equals W to float32 rounding. The plain version of the
    ``cin_split`` kernel that the wrapper launches on the card."""
    hp, h, m = W.shape
    K = h * m
    w = W.reshape(hp, K)
    hi = tf32_round(w)
    w2 = W.new_zeros((2, hp, -(-K // 4) * 4))
    w2[0, :, :K] = hi
    w2[1, :, :K] = tf32_round(w - hi)
    return w2


def split_weights_on_card(W: torch.Tensor) -> torch.Tensor:
    """:func:`split_weights` by the ``cin_split`` kernel, for a CUDA
    tensor W; the same bits."""
    hp, h, m = W.shape
    return _on_card("cin_split", (2, hp, -(-h * m // 4) * 4), W, hp, h * m)


def depth_split(rows: int, hp: int, K: int) -> int:
    """The number of depth chunks s for a layer of ``rows`` = B*D rows,
    h' maps and depth K = h*m, from the shapes alone: 1 when the
    128 x 200 tiles fill the card's SMs, else as many chunks as keep
    one wave (tiles * s <= CARD_SMS), each of at least
    MIN_CHUNK_TILES k-tiles of 32."""
    tiles = -(-rows // TILE_ROWS) * -(-hp // TILE_MAPS)
    if tiles == 0 or tiles >= CARD_SMS:
        return 1
    return max(1, min(CARD_SMS // tiles,
                      -(-K // TILE_K) // MIN_CHUNK_TILES))


def split_weights_x0(W: torch.Tensor) -> torch.Tensor:
    """dx0's B operand: W (h', h, m) -> (2, m*h8, Kp) float32, row
    c = j*h8 + a holding W[:, a, j] in its two TF32 parts (h8 = h
    rounded up to 8, rows a >= h zero; Kp = h' rounded up to 4, zero
    past h'): :func:`split_weights` of W permuted to (m, h8, h'). The
    plain version of the ``cin_split_wx0`` kernel."""
    hp, h, m = W.shape
    h8 = -(-h // 8) * 8
    wp = W.new_zeros((m, h8, hp))
    wp[:, :h] = W.permute(2, 1, 0)
    return split_weights(wp.reshape(m * h8, hp, 1))


def split_grad_t(g: torch.Tensor) -> torch.Tensor:
    """dW's B operand: g (B, h', D) -> (2, h', Rp) float32, column
    r = b*D + d holding g[b, :, d] in its two TF32 parts (Rp = B*D
    rounded up to 4, zero past B*D): :func:`split_weights` of g
    transposed to (h', B*D). The plain version of the ``cin_split_gt``
    kernel."""
    B, hp, D = g.shape
    return split_weights(g.permute(1, 0, 2).reshape(hp, B * D, 1))


def split_grad_rows(g: torch.Tensor) -> torch.Tensor:
    """dx0's A operand: g (B, h', D) -> (2, B*D, Kp) float32, row
    r = b*D + d holding g[b, :, d] in its two TF32 parts (Kp = h'
    rounded up to 4, zero past h'): :func:`split_weights` of g permuted
    to (B*D, h'). The plain version of the ``cin_split_g`` kernel."""
    B, hp, D = g.shape
    return split_weights(g.permute(0, 2, 1).reshape(B * D, hp, 1))


def _on_card(name: str, shape, src: torch.Tensor, *args) -> torch.Tensor:
    """A new float32 ``shape`` tensor written from ``src`` by the split
    kernel ``name`` of :func:`_launcher` (called as fn(src, out, *args,
    stream)); for a fake ``src`` (the dry run) left empty, with nothing
    recorded: a pre-pass's work is inside its wrapper's cost."""
    out = torch.empty(shape, dtype=torch.float32, device=src.device)
    if out.numel() == 0 or _cost.is_fake(src):
        return out
    src = src.contiguous()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    _build.check(_launcher()[name](src.data_ptr(), out.data_ptr(), *args,
                                   stream), name)
    return out


def split_weights_x0_on_card(W: torch.Tensor) -> torch.Tensor:
    """:func:`split_weights_x0` by the ``cin_split_wx0`` kernel, for a
    CUDA tensor W; the same bits."""
    hp, h, m = W.shape
    return _on_card("cin_split_wx0", (2, m * -(-h // 8) * 8, -(-hp // 4) * 4),
                    W, hp, h, m)


def split_grad_t_on_card(g: torch.Tensor) -> torch.Tensor:
    """:func:`split_grad_t` by the ``cin_split_gt`` kernel, for a CUDA
    tensor g; the same bits."""
    B, hp, D = g.shape
    return _on_card("cin_split_gt", (2, hp, -(-B * D // 4) * 4), g, B, hp, D)


def split_grad_rows_on_card(g: torch.Tensor) -> torch.Tensor:
    """:func:`split_grad_rows` by the ``cin_split_g`` kernel, for a CUDA
    tensor g; the same bits."""
    B, hp, D = g.shape
    return _on_card("cin_split_g", (2, B * D, -(-hp // 4) * 4), g, B, hp, D)


def x0grad_tiling(m: int, h: int) -> tuple[int, int, int, int]:
    """(h8, J, n_sub, units a row tile) of dx0's kernel for x0 width m
    and xk width h: h8 = h rounded up to 8 (the columns of one j in the
    B operand); a 200-column tile holds J = 200 // h8 whole j, or, past
    h8 = 200, one j over n_sub = ceil(h8 / 200) column tiles walked in
    order; a row tile has ceil(m / J) units."""
    h8 = -(-h // 8) * 8
    J = TILE_MAPS // h8 if h8 <= TILE_MAPS else 1
    return h8, J, -(-h8 // TILE_MAPS), -(-m // J)


def _layer_on_card(x0: torch.Tensor, xk: torch.Tensor,
                   W: torch.Tensor) -> torch.Tensor:
    """The ``cin`` kernel on CUDA tensors of checked shapes: the W split,
    the layer launch and, for s > 1, the chunk sum."""
    B, m, D = x0.shape
    h, hp = xk.shape[1], W.shape[0]
    x0, xk = x0.contiguous(), xk.contiguous()
    out = torch.empty((B, hp, D), dtype=torch.float32, device=x0.device)
    if out.numel() == 0:
        return out
    w2 = split_weights_on_card(W)
    s = depth_split(B * D, hp, h * m)
    scratch = torch.empty((s, B, hp, D), dtype=torch.float32,
                          device=x0.device) if s > 1 else None
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = _launcher()["cin"](x0.data_ptr(), xk.data_ptr(), w2.data_ptr(),
                             out.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             B, m, h, hp, D, s, stream)
    _build.check(err, "cin")
    return out


def cin_layer_cost(x0, xk, W) -> _cost.KernelCost:
    """One layer's work: x0, xk and W read once and the (B, h', D) output
    written once, float32; 2*B*D*h*m*h' flops done three times on the
    TF32 tensor cores (3xTF32)."""
    B, m, D = x0.shape
    h, hp = xk.shape[1], W.shape[0]
    return _cost.KernelCost(
        bytes=4.0 * (x0.numel() + xk.numel() + W.numel() + B * hp * D),
        flops=2.0 * B * D * h * m * hp, rate=_cost.TF32_OPS_PER_S,
        passes=3)


def cin_grad_cost(x0, xk, W, g, out) -> _cost.KernelCost:
    """One gradient kernel's work: x0, xk, W and g read once and the
    gradient ``out`` written once; the layer's flops, 3xTF32."""
    return dataclasses.replace(cin_layer_cost(x0, xk, W), bytes=4.0 * (
        x0.numel() + xk.numel() + W.numel() + g.numel() + out.numel()))


def _count(fn) -> None:
    with _build.counter_lock:
        fn.launches += 1


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, W: torch.Tensor,
              backend: str = "auto") -> torch.Tensor:
    """One CIN layer -> (B, h', D) float32. With ``backend="auto"`` a
    CUDA tensor runs the Hopper kernel (it raises if the kernel cannot
    be built or launched) and a CPU tensor the plain version; when
    autograd records a graph through an input, the call goes through
    :class:`CinLayer`, whose backward runs the gradient wrappers.
    ``"plain"`` takes the plain version on any device (autograd then
    differentiates its einsums). ``cin_layer.launches`` counts the
    forward kernel's launches."""
    if backend not in CIN_BACKENDS:
        raise ValueError(f"cin backend {backend!r} not in {CIN_BACKENDS}")
    _check(x0, xk, W)
    if backend == "plain":
        return cin_layer_ref(x0, xk, W)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, xk, W)):
        return CinLayer.apply(x0, xk, W)
    return _forward(x0, xk, W)


def _forward(x0, xk, W) -> torch.Tensor:
    if _cost.is_fake(x0, xk, W):
        out = x0.new_empty((x0.shape[0], W.shape[0], x0.shape[2]))
        _cost.record("cin_layer", cin_layer_cost(x0, xk, W), x0.device)
        return out
    if x0.device.type == "cpu":
        return cin_layer_ref(x0, xk, W)
    out = _layer_on_card(x0, xk, W)
    _count(cin_layer)
    return out


cin_layer.launches = 0


def _check_grad(x0, xk, W, g) -> None:
    _check(x0, xk, W)
    want = (x0.shape[0], W.shape[0], x0.shape[2])
    if g.shape != want or g.dtype != torch.float32 or g.device != x0.device:
        raise ValueError(f"cin gradient g: {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}, expected float32 {want} on "
                         f"{x0.device}")


def cin_grad_xk(x0: torch.Tensor, xk: torch.Tensor, W: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """dL/dxk (B, h, D) of one layer for g = dL/dout (B, h', D): on a
    CUDA tensor the layer kernel on (x0, g, W permuted (1, 0, 2)), on a
    CPU tensor :func:`~repro_torch.kernels.cin.ref.cin_grad_xk_plain`.
    ``cin_grad_xk.launches`` counts its launches."""
    _check_grad(x0, xk, W, g)
    if _cost.is_fake(x0, xk, W, g):
        return _fake_grad("cin_grad_xk", x0, xk, W, g, xk.shape)
    if x0.device.type == "cpu":
        return cin_grad_xk_plain(x0, W, g)
    out = _layer_on_card(x0, g, W.permute(1, 0, 2).contiguous())
    _count(cin_grad_xk)
    return out


def cin_grad_x0(x0: torch.Tensor, xk: torch.Tensor, W: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """dL/dx0 (B, m, D) of one layer: on a CUDA tensor the ``cin_grad_x0``
    kernel (a 3xTF32 GEMM over :func:`split_grad_rows` of g and
    :func:`split_weights_x0` of W, both brought by TMA, then a dot with
    xk in its epilogue), on a CPU tensor
    :func:`~repro_torch.kernels.cin.ref.cin_grad_x0_plain`.
    ``cin_grad_x0.launches`` counts its launches."""
    _check_grad(x0, xk, W, g)
    if _cost.is_fake(x0, xk, W, g):
        return _fake_grad("cin_grad_x0", x0, xk, W, g, x0.shape)
    if x0.device.type == "cpu":
        return cin_grad_x0_plain(xk, W, g)
    B, m, D = x0.shape
    h, hp = xk.shape[1], W.shape[0]
    xk, g = xk.contiguous(), g.contiguous()
    out = torch.empty((B, m, D), dtype=torch.float32, device=x0.device)
    if out.numel() == 0:
        return out
    wt = split_weights_x0_on_card(W)
    g2 = split_grad_rows_on_card(g)
    _, J, n_sub, _ = x0grad_tiling(m, h)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = _launcher()["cin_grad_x0"](xk.data_ptr(), g2.data_ptr(),
                                     wt.data_ptr(), out.data_ptr(), B, m, h,
                                     hp, D, J, n_sub, stream)
    _build.check(err, "cin_grad_x0")
    _count(cin_grad_x0)
    return out


def cin_grad_w(x0: torch.Tensor, xk: torch.Tensor, W: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """dL/dW (h', h, m) of one layer: on a CUDA tensor the ``cin_wgrad``
    kernel (3xTF32 ``wgmma`` over the B*D data rows with
    :func:`split_grad_t` of g as its B operand, depth-split by
    :func:`depth_split` into chunks summed in chunk order), on a CPU
    tensor :func:`~repro_torch.kernels.cin.ref.cin_grad_w_plain`.
    ``cin_grad_w.launches`` counts its launches."""
    _check_grad(x0, xk, W, g)
    if _cost.is_fake(x0, xk, W, g):
        return _fake_grad("cin_grad_w", x0, xk, W, g, W.shape)
    if x0.device.type == "cpu":
        return cin_grad_w_plain(x0, xk, g)
    B, m, D = x0.shape
    h, hp = xk.shape[1], W.shape[0]
    x0, xk = x0.contiguous(), xk.contiguous()
    dw = torch.empty(W.shape, dtype=torch.float32, device=x0.device)
    if dw.numel() == 0:
        return dw
    gt = split_grad_t_on_card(g)
    s = depth_split(h * m, hp, B * D)
    scratch = torch.empty((s, hp, h * m), dtype=torch.float32,
                          device=x0.device) if s > 1 else None
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = _launcher()["cin_wgrad"](x0.data_ptr(), xk.data_ptr(),
                                   gt.data_ptr(), dw.data_ptr(),
                                   None if scratch is None
                                   else scratch.data_ptr(),
                                   B, m, h, hp, D, s, stream)
    _build.check(err, "cin_wgrad")
    _count(cin_grad_w)
    return dw


cin_grad_xk.launches = cin_grad_x0.launches = cin_grad_w.launches = 0


def _fake_grad(name: str, x0, xk, W, g, shape) -> torch.Tensor:
    """A gradient wrapper on fake tensors: its empty output and one
    recorded launch."""
    out = x0.new_empty(shape)
    _cost.record(name, cin_grad_cost(x0, xk, W, g, out), x0.device)
    return out


class CinLayer(torch.autograd.Function):
    """One CIN layer under autograd: the forward of :func:`cin_layer`,
    and a backward that computes each gradient an input needs through
    :func:`cin_grad_x0`, :func:`cin_grad_xk` and :func:`cin_grad_w`
    (kernels on the card, plain formulas on the CPU). At the first
    layer xk is x0 itself: autograd adds the two gradients it gets for
    that one tensor."""

    @staticmethod
    def forward(ctx, x0, xk, W):
        ctx.save_for_backward(x0, xk, W)
        return _forward(x0, xk, W)

    @staticmethod
    def backward(ctx, g):
        x0, xk, W = ctx.saved_tensors
        g = g.contiguous()
        want_x0, want_xk, want_w = ctx.needs_input_grad
        return (cin_grad_x0(x0, xk, W, g) if want_x0 else None,
                cin_grad_xk(x0, xk, W, g) if want_xk else None,
                cin_grad_w(x0, xk, W, g) if want_w else None)
