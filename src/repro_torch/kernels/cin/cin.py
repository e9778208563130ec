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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cin.ref import cin_layer_ref

CIN_BACKENDS = ("auto", "plain")
TILE_ROWS, TILE_MAPS, TILE_K = 128, 200, 32   # csrc/cin.cu kBM, kBN, kBK
CARD_SMS = 132         # the H100 SXM's SMs: the split targets one wave
MIN_CHUNK_TILES = 8    # k-tiles a depth chunk keeps at least
_launch = []   # the bound C functions, filled on first launch


def _launcher():
    """(cin_split_launch, cin_launch) of the built library."""
    if not _launch:
        lib = _build.load("cin")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        split, layer = lib.cin_split_launch, lib.cin_launch
        split.argtypes = [ptr, ptr, i32, i32, ptr]
        layer.argtypes = [ptr] * 5 + [ctypes.c_longlong] + [i32] * 5 + [ptr]
        split.restype = layer.restype = ctypes.c_int
        _launch.extend((split, layer))
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


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, W: torch.Tensor,
              backend: str = "auto") -> torch.Tensor:
    """One CIN layer -> (B, h', D) float32. With ``backend="auto"`` a
    CUDA tensor runs the Hopper kernel (it raises if the kernel cannot
    be built or launched) and a CPU tensor the plain version;
    ``"plain"`` takes the plain version on any device.
    ``cin_layer.launches`` counts kernel launches."""
    if backend not in CIN_BACKENDS:
        raise ValueError(f"cin backend {backend!r} not in {CIN_BACKENDS}")
    _check(x0, xk, W)
    if backend == "plain" or x0.device.type == "cpu":
        return cin_layer_ref(x0, xk, W)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, xk, W)):
        raise RuntimeError("the cin kernel has no backward: call it under "
                           "torch.no_grad() or on tensors without grad")
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
    cin_layer.launches += 1
    return out


cin_layer.launches = 0
