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
launches: :func:`cin_grad_xk` (the layer kernel on x0, g and W
permuted), :func:`cin_grad_x0` (the layer kernel on xk, g and W
permuted; xk in the x0 slot is 200 wide at layers 2-3, so the kernel
reads x0 from device memory instead of its shared-memory slab) and
:func:`cin_grad_w` (``cin_wgrad``, the same consumers over a GEMM whose
depth is the B*D data rows). On a CUDA tensor they launch or raise; on
a CPU tensor they run the plain formulas of ``ref.py``. Under
``no_grad`` / ``inference_mode`` :func:`cin_layer` launches the layer
kernel directly, as serving always has.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cin.ref import (cin_grad_w_plain, cin_grad_x0_plain,
                                         cin_grad_xk_plain, cin_layer_ref)

CIN_BACKENDS = ("auto", "plain")
TILE_ROWS, TILE_MAPS, TILE_K = 128, 200, 32   # csrc/cin.cu kBM, kBN, kBK
CARD_SMS = 132         # the H100 SXM's SMs: the split targets one wave
MIN_CHUNK_TILES = 8    # k-tiles a depth chunk keeps at least
_launch = []   # the bound C functions, filled on first launch


def _launcher():
    """(cin_split_launch, cin_launch, cin_wgrad_launch) of the built
    library."""
    if not _launch:
        lib = _build.load("cin")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        split, layer = lib.cin_split_launch, lib.cin_launch
        wgrad = lib.cin_wgrad_launch
        split.argtypes = [ptr, ptr, i32, i32, ptr]
        layer.argtypes = [ptr] * 5 + [ctypes.c_longlong] + [i32] * 5 + [ptr]
        wgrad.argtypes = layer.argtypes
        split.restype = layer.restype = wgrad.restype = ctypes.c_int
        _launch.extend((split, layer, wgrad))
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
    K = h * m
    w2 = torch.empty((2, hp, -(-K // 4) * 4), dtype=torch.float32,
                     device=W.device)
    W = W.contiguous()
    stream = torch.cuda.current_stream(W.device).cuda_stream
    _build.check(_launcher()[0](W.data_ptr(), w2.data_ptr(), hp, K, stream),
                 "cin_split")
    return w2


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
    err = _launcher()[1](x0.data_ptr(), xk.data_ptr(), w2.data_ptr(),
                         out.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         B, m, h, hp, D, s, stream)
    _build.check(err, "cin")
    return out


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
    if x0.device.type == "cpu":
        return cin_grad_xk_plain(x0, W, g)
    out = _layer_on_card(x0, g, W.permute(1, 0, 2).contiguous())
    _count(cin_grad_xk)
    return out


def cin_grad_x0(x0: torch.Tensor, xk: torch.Tensor, W: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """dL/dx0 (B, m, D) of one layer: on a CUDA tensor the layer kernel
    on (xk, g, W permuted (2, 0, 1)), xk in the x0 slot (read from
    device memory where it is too wide for the kernel's shared-memory
    slab), on a CPU tensor :func:`~repro_torch.kernels.cin.ref.
    cin_grad_x0_plain`. ``cin_grad_x0.launches`` counts its launches."""
    _check_grad(x0, xk, W, g)
    if x0.device.type == "cpu":
        return cin_grad_x0_plain(xk, W, g)
    out = _layer_on_card(xk, g, W.permute(2, 0, 1).contiguous())
    _count(cin_grad_x0)
    return out


def cin_grad_w(x0: torch.Tensor, xk: torch.Tensor, W: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """dL/dW (h', h, m) of one layer: on a CUDA tensor the ``cin_wgrad``
    kernel (3xTF32 ``wgmma`` over the B*D data rows, depth-split by
    :func:`depth_split` into chunks summed in chunk order), on a CPU
    tensor :func:`~repro_torch.kernels.cin.ref.cin_grad_w_plain`.
    ``cin_grad_w.launches`` counts its launches."""
    _check_grad(x0, xk, W, g)
    if x0.device.type == "cpu":
        return cin_grad_w_plain(x0, xk, g)
    B, m, D = x0.shape
    h, hp = xk.shape[1], W.shape[0]
    x0, xk, g = x0.contiguous(), xk.contiguous(), g.contiguous()
    dw = torch.empty(W.shape, dtype=torch.float32, device=x0.device)
    if dw.numel() == 0:
        return dw
    s = depth_split(h * m, hp, B * D)
    scratch = torch.empty((s, hp, h * m), dtype=torch.float32,
                          device=x0.device) if s > 1 else None
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = _launcher()[2](x0.data_ptr(), xk.data_ptr(), g.data_ptr(),
                         dw.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         B, m, h, hp, D, s, stream)
    _build.check(err, "cin_wgrad")
    _count(cin_grad_w)
    return dw


cin_grad_xk.launches = cin_grad_x0.launches = cin_grad_w.launches = 0


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
