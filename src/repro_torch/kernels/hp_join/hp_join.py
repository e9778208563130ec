"""Batched single-pair join: the Hopper kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/hp_join/hp_join.py``
(``_kernel`` / ``hp_join``). Both versions compute, for each pair b,

    s[b] = sum_ij [keys[us[b], i] == keys[vs[b], j] != PAD]
                  * vals[us[b], i] * vals[vs[b], j]

over a packed table whose rows are sorted ascending with PAD
(INT32_PAD_KEY) trailing and whose values are pre-multiplied by
sqrt(d_k) (``ops.fold_sqrt_d``). The kernel (``csrc/hp_join.cu``) reads
the rows through ``us``/``vs`` itself: one block a pair, row v copied
into shared memory with 16-byte loads, a binary search of it per entry
of row u, and a fixed-order reduction (warp shuffles, then the warps in
order), so two calls give the same bits. :func:`hp_join_cost` counts a
call's work; on ``FakeTensor`` inputs (the analyzer's pair program,
``analysis/programs.py``) the wrapper makes its output empty and records
that cost (``kernels/cost.py``), every slot of the pairs' rows taken as
live.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost

_launch = []   # the bound C function, filled on first launch


def _launcher():
    if not _launch:
        fn = _build.load("hp_join").hp_join_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


def hp_join_plain(keys: torch.Tensor, vals: torch.Tensor, us: torch.Tensor,
                  vs: torch.Tensor) -> torch.Tensor:
    """The plain version: for each entry of row u, the sum of row v's
    values over the run of equal keys (two ``searchsorted`` bounds and a
    float64 prefix sum), times the entry's value, summed per pair."""
    ku, xu = keys[us.long()], vals[us.long()]
    kv, xv = keys[vs.long()], vals[vs.long()]
    lo = torch.searchsorted(kv, ku)
    hi = torch.searchsorted(kv, ku, right=True)
    cs = torch.nn.functional.pad(torch.cumsum(xv.double(), dim=1), (1, 0))
    run = cs.gather(1, hi) - cs.gather(1, lo)
    s = torch.where(ku != INT32_PAD_KEY, xu.double() * run, 0.0)
    return s.sum(dim=1).float()


def _check(keys, vals, us, vs) -> None:
    if us.dim() != 1 or vs.dim() != 1:
        # the reference's hp_join(ku, vu, kv, vv) takes gathered (B, K)
        # rows; the port's kernel gathers the rows itself from a table
        # and row ids, and has no gathered form (ROADMAP.md)
        raise TypeError("hp_join takes (keys, vals, us, vs): a packed "
                        "table and (B,) row ids, not gathered rows")
    if keys.dim() != 2 or vals.shape != keys.shape:
        raise ValueError(f"keys/vals must be one (rows, K) shape, got "
                         f"{tuple(keys.shape)} and {tuple(vals.shape)}")
    if us.shape != vs.shape:
        raise ValueError("us/vs must be (B,) of one shape")
    if keys.dtype != torch.int32 or vals.dtype != torch.float32 or \
            us.dtype != torch.int32 or vs.dtype != torch.int32:
        raise TypeError("hp_join takes int32 keys/us/vs and float32 vals")
    if len({t.device for t in (keys, vals, us, vs)}) != 1:
        raise ValueError("hp_join arguments must share one device")
    if not all(t.is_contiguous() for t in (keys, vals, us, vs)):
        raise ValueError("hp_join arguments must be contiguous")


def hp_join_cost(pairs: int, live_u: int, live_v: int,
                 width: int) -> _cost.KernelCost:
    """The work of one call over ``pairs`` pairs whose u rows hold
    ``live_u`` live entries and v rows ``live_v``, in rows of ``width``
    slots: each live entry's key and value read once (8 bytes), the two
    ids and the score of each pair (12 bytes); a binary search of row v
    (log2 width + 1 compares) and a multiply-add for each entry of row
    u, two operations a step."""
    return _cost.KernelCost(
        bytes=8.0 * (live_u + live_v) + 12.0 * pairs,
        flops=2.0 * live_u * (math.log2(width) + 1))


def hp_join(keys: torch.Tensor, vals: torch.Tensor, us: torch.Tensor,
            vs: torch.Tensor) -> torch.Tensor:
    """(B,) float32 pair scores. On a CUDA device the Hopper kernel runs
    (it raises if it cannot be built or launched); for CPU tensors the
    plain version runs, for fake ones nothing (the module docstring).
    ``hp_join.launches`` counts kernel launches."""
    _check(keys, vals, us, vs)
    if _cost.is_fake(keys, vals, us, vs):
        B, K = us.shape[0], keys.shape[1]
        out = torch.empty(B, dtype=torch.float32, device=keys.device)
        _cost.worst_case("hp_join: every slot of the pairs' rows live")
        _cost.record("hp_join", hp_join_cost(B, B * K, B * K, K),
                     keys.device, out=(out,))
        return out
    if keys.device.type == "cpu":
        return hp_join_plain(keys, vals, us, vs)
    out = torch.empty(us.shape[0], dtype=torch.float32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _launcher()(keys.data_ptr(), vals.data_ptr(), us.data_ptr(),
                      vs.data_ptr(), us.shape[0], keys.shape[1],
                      out.data_ptr(), stream)
    _build.check(err, "hp_join")
    with _build.counter_lock:
        hp_join.launches += 1
    return out


hp_join.launches = 0
