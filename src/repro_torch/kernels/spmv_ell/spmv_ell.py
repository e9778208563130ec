"""Â applied to a node-major slab: the Hopper kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/spmv_ell/spmv_ell.py``
(``_kernel`` / ``spmm_block``). Both versions compute, for x (n, F)
float32 and an :class:`~repro_torch.kernels.spmv_ell.ops.SpmmLayout`,

    out[v, :] = sum_{e in row v} w_e * x[in_idx_e, :]

The kernel (``csrc/spmm.cu``) sums each output in a fixed order that
depends only on the row (no atomics): a group of lanes per light row, a
block per heavy row with its slot sums added in shared memory. It is
bound by the bytes of the slab it gathers and writes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_launch = []   # the bound C function, filled on first launch


def _launcher():
    if not _launch:
        fn = _build.load("spmm").spmm_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [i32, ptr, i32, i32, ptr]
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


def spmm_plain(x: torch.Tensor, layout, out: torch.Tensor | None = None
               ) -> torch.Tensor:
    """The plain version: per output row the sum of w_e * x[in_idx_e]
    over its edges, in edge order (``torch.segment_reduce``)."""
    msgs = x[layout.in_idx.long()] * layout.w[:, None]
    y = torch.segment_reduce(msgs, "sum", offsets=layout.in_ptr.long(),
                             axis=0, unsafe=True, initial=0.0)
    return y if out is None else out.copy_(y)


def _check(x, layout, out) -> None:
    lay = (layout.in_ptr, layout.in_idx, layout.w, layout.heavy,
           layout.light)
    if x.dim() != 2 or x.shape[0] != layout.n or \
            layout.in_ptr.shape != (layout.n + 1,) or \
            layout.w.shape != layout.in_idx.shape or \
            layout.heavy.numel() + layout.light.numel() != layout.n or \
            (out is not None and out.shape != x.shape):
        raise ValueError(
            f"spmm shapes: x {tuple(x.shape)} layout n={layout.n} out "
            f"{None if out is None else tuple(out.shape)}")
    if x.dtype != torch.float32 or layout.w.dtype != torch.float32 or \
            (out is not None and out.dtype != torch.float32) or \
            any(t.dtype != torch.int32 for t in lay[:2] + lay[3:]):
        raise TypeError("spmm takes float32 x/out/w and int32 layout "
                        "indices")
    ts = (x,) + lay + (() if out is None else (out,))
    if len({t.device for t in ts}) != 1:
        raise ValueError("spmm arguments must share one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("spmm arguments must be contiguous")


def spmm(x: torch.Tensor, layout, out: torch.Tensor | None = None
         ) -> torch.Tensor:
    """Â x for a node-major (n, F) float32 ``x``, written into ``out``
    (allocated when None). On a CUDA device the Hopper kernel runs (it
    raises if it cannot be built or launched); for CPU tensors the plain
    version runs. ``spmm.launches`` counts kernel launches."""
    _check(x, layout, out)
    if x.device.type == "cpu":
        return spmm_plain(x, layout, out)
    if out is None:
        out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.data_ptr(), out.data_ptr(), layout.in_ptr.data_ptr(),
                      layout.in_idx.data_ptr(), layout.w.data_ptr(),
                      layout.heavy.data_ptr(), layout.heavy.numel(),
                      layout.light.data_ptr(), layout.light.numel(),
                      x.shape[1], stream)
    _build.check(err, "spmm")
    spmm.launches += 1
    return out


spmm.launches = 0
