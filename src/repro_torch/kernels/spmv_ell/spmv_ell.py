"""Â applied to a node-major slab: the Hopper kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/spmv_ell/spmv_ell.py``
(``_kernel`` / ``spmm_block``). Both versions compute, for x (n, F)
float32 and an :class:`~repro_torch.kernels.spmv_ell.ops.SpmmLayout`,

    out[v, :] = sum_{e in row v} w_e * p(x[in_idx_e, :])

with p the identity, or with ``tau`` the prune p(x) = x if x > tau else
0 (compared in float32). With ``tau`` two masks of live segments ride
along (a segment is 32 columns of one row; :func:`segment_live`):
``live`` says which segments of x may hold an entry > tau, so the
kernel reads no other, and ``live_out`` receives the same mask for
``out``, which the caller's next step passes as its ``live``.

The kernel (``csrc/spmm.cu``) sums each output in a fixed order that
depends only on the row (no atomics): a group of lanes per light row, a
block per heavy row with its slot sums added in shared memory. A
skipped segment would only have added w * 0, so the masked result
equals the dense one bit for bit. :func:`spmm_cost` counts a call's
work; no dry-run cell reaches this kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost

SEGMENT = 32        # columns a bit of the live mask covers
WORD = 32 * SEGMENT  # columns a mask word covers

_launch = []   # the bound C function, filled on first launch


def _launcher():
    if not _launch:
        fn = _build.load("spmm").spmm_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 6 + [i32, ptr, i32, i32, i32, ctypes.c_float]
                       + [ptr] * 3)
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


def mask_words(F: int) -> int:
    """int32 words a row of the live mask takes for F columns."""
    return -(-F // WORD)


def segment_live(x: torch.Tensor, tau: float) -> torch.Tensor:
    """The live mask of ``x`` at ``tau``: int32 (n, ceil(F/1024)), bit s
    of row r's word w set iff some x[r, 1024 w + 32 s + j] (j < 32) is
    > tau."""
    n, F = x.shape
    segs, words = -(-F // SEGMENT), mask_words(F)
    hot = torch.zeros((n, segs * SEGMENT), dtype=torch.bool,
                      device=x.device)
    hot[:, :F] = x > tau
    live = torch.zeros((n, words * 32), dtype=torch.int64, device=x.device)
    live[:, :segs] = hot.view(n, segs, SEGMENT).any(dim=2)
    bit = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=x.device),
        torch.arange(32, device=x.device))
    word = (live.view(n, words, 32) * bit).sum(dim=2)
    # bit 31 is the int32 sign bit
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def spmm_plain(x: torch.Tensor, layout, out: torch.Tensor | None = None, *,
               tau: float | None = None, live: torch.Tensor | None = None,
               live_out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: per output row the sum of w_e * p(x[in_idx_e])
    over its edges, in edge order (``torch.segment_reduce``), pruned
    densely. ``live`` is not read: a truthful mask cannot change the
    sum. ``live_out`` receives :func:`segment_live` of the result."""
    if live_out is not None and tau is None:
        raise ValueError("spmm: live_out needs tau")
    if tau is not None:
        x = torch.where(x > tau, x, 0.0)
    msgs = x[layout.in_idx.long()] * layout.w[:, None]
    y = torch.segment_reduce(msgs, "sum", offsets=layout.in_ptr.long(),
                             axis=0, unsafe=True, initial=0.0)
    if live_out is not None:
        live_out.copy_(segment_live(y, tau))
    return y if out is None else out.copy_(y)


def _check(x, layout, out, tau, live, live_out) -> None:
    """The per-call arguments against the layout (whose own arrays
    :class:`SpmmLayout` checked when it was made)."""
    if x.dim() != 2 or x.shape[0] != layout.n or \
            (out is not None and out.shape != x.shape):
        raise ValueError(
            f"spmm shapes: x {tuple(x.shape)} layout n={layout.n} out "
            f"{None if out is None else tuple(out.shape)}")
    if x.dtype != torch.float32 or \
            (out is not None and out.dtype != torch.float32):
        raise TypeError("spmm takes float32 x and out")
    masks = tuple(m for m in (live, live_out) if m is not None)
    if masks and tau is None:
        raise ValueError("spmm: live and live_out need tau")
    words = mask_words(x.shape[1])
    for m in masks:
        if m.dtype != torch.int32:
            raise TypeError(f"spmm masks are int32, not {m.dtype}")
        if m.shape != (layout.n, words):
            raise ValueError(f"spmm mask shape {tuple(m.shape)}, expected "
                             f"{(layout.n, words)}")
    ts = (x,) + (() if out is None else (out,)) + masks
    if any(t.device != layout.device for t in ts):
        raise ValueError("spmm arguments must share the layout's device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("spmm arguments must be contiguous")
    if (out is not None and out.data_ptr() == x.data_ptr()) or \
            (len(masks) == 2 and live.data_ptr() == live_out.data_ptr()):
        raise ValueError("spmm writes out and live_out apart from x and "
                         "live")


def spmm_cost(n: int, F: int, edges: int, live_segments: int | None = None,
              edge_segments: int | None = None,
              mask_words: int = 0) -> _cost.KernelCost:
    """The work of one call on an (n, F) frontier over ``edges`` edges.
    Dense (``live_segments`` None): x read whole, a multiply-add an edge
    and a column. Masked: 128 bytes for each of the ``live_segments``
    segments of x read, ``mask_words`` words of the live mask read and
    of live_out written, and a multiply-add for each column of each
    edge's live source segments (``edge_segments`` of 32 columns). Both:
    the (n, F) result written whole and the CSR (8 bytes an edge, 4 a
    row pointer)."""
    x_bytes = 4.0 * n * F if live_segments is None else 128.0 * live_segments
    flops = 2.0 * edges * F if edge_segments is None else \
        2.0 * 32 * edge_segments
    return _cost.KernelCost(
        bytes=x_bytes + 4.0 * n * F + 8.0 * edges + 4.0 * (n + 1)
        + 2 * 4.0 * mask_words, flops=flops)


def spmm(x: torch.Tensor, layout, out: torch.Tensor | None = None, *,
         tau: float | None = None, live: torch.Tensor | None = None,
         live_out: torch.Tensor | None = None) -> torch.Tensor:
    """Â x, or with ``tau`` Â prune_tau(x), for a node-major (n, F)
    float32 ``x``, written into ``out`` (allocated when None). ``live``
    (int32 (n, ceil(F/1024)), needs ``tau``): the segments of x that may
    hold an entry > tau; the kernel reads no other. ``live_out`` (same
    shape) receives the mask of the result. On a CUDA device the Hopper
    kernel runs (it raises if it cannot be built or launched); for CPU
    tensors the plain version runs. ``spmm.launches`` counts kernel
    launches."""
    if tau is not None:
        tau = ctypes.c_float(tau).value    # the kernel compares in float32
    _check(x, layout, out, tau, live, live_out)
    if x.device.type == "cpu":
        return spmm_plain(x, layout, out, tau=tau, live_out=live_out)
    if out is None:
        out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.data_ptr(), out.data_ptr(), layout.in_ptr.data_ptr(),
                      layout.in_idx.data_ptr(), layout.w.data_ptr(),
                      layout.heavy.data_ptr(), layout.heavy.numel(),
                      layout.light.data_ptr(), layout.light.numel(),
                      x.shape[1], int(tau is not None),
                      0.0 if tau is None else tau,
                      None if live is None else live.data_ptr(),
                      None if live_out is None else live_out.data_ptr(),
                      stream)
    _build.check(err, "spmm")
    with _build.counter_lock:
        spmm.launches += 1
    return out


spmm.launches = 0
