"""One CIN layer: the Hopper kernel's wrapper and the backend switch.

Replaces the TPU kernel ``src/repro/kernels/cin/cin.py`` (``_kernel`` /
``cin_layer``). Both versions compute, for x0 (B, m, D), xk (B, h, D)
and W (h', h, m), all float32,

    out[b, i, d] = sum_{a, j} W[i, a, j] * xk[b, a, d] * x0[b, j, d]

The kernel (``csrc/cin.cu``) forms the outer-product tile of one ``a``
at a time in shared memory and accumulates in float32 registers with
FMA (no TF32), so the (B, h, m, D) product never reaches device memory.
It is bound by operations: 2*B*D*h*m*h' at the card's float32 rate.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cin.ref import cin_layer_ref

CIN_BACKENDS = ("auto", "plain")
_launch = []   # the bound C function, filled on first launch


def _launcher():
    if not _launch:
        fn = _build.load("cin").cin_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [ctypes.c_longlong] + [i32] * 4 + [ptr]
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


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
    wt = W.permute(1, 2, 0).contiguous()          # (h, m, h')
    out = torch.empty((B, hp, D), dtype=torch.float32, device=x0.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = _launcher()(x0.data_ptr(), xk.data_ptr(), wt.data_ptr(),
                      out.data_ptr(), B, m, h, hp, D, stream)
    _build.check(err, "cin")
    cin_layer.launches += 1
    return out


cin_layer.launches = 0
