"""Batched single-pair join: the Hopper kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/hp_join/hp_join.py``
(``_kernel`` / ``hp_join``). Both versions compute, for each pair b,

    s[b] = sum_ij [keys[us[b], i] == keys[vs[b], j] != PAD]
                  * vals[us[b], i] * vals[vs[b], j]

over a packed table whose rows are sorted ascending with PAD
(INT32_PAD_KEY) trailing and whose values are pre-multiplied by
sqrt(d_k) (``ops.fold_sqrt_d``). The kernel (``csrc/hp_join.cu``) reads
the rows through ``us``/``vs`` itself; one warp per pair, a binary
search per entry, a fixed-order shuffle reduction. It is bound by the
bytes of the two rows each pair reads.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hp_index import INT32_PAD_KEY
from repro_torch.kernels import _build

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
    if keys.dim() != 2 or vals.shape != keys.shape:
        raise ValueError(f"keys/vals must be one (rows, K) shape, got "
                         f"{tuple(keys.shape)} and {tuple(vals.shape)}")
    if us.dim() != 1 or us.shape != vs.shape:
        raise ValueError("us/vs must be (B,) of one shape")
    if keys.dtype != torch.int32 or vals.dtype != torch.float32 or \
            us.dtype != torch.int32 or vs.dtype != torch.int32:
        raise TypeError("hp_join takes int32 keys/us/vs and float32 vals")
    if len({t.device for t in (keys, vals, us, vs)}) != 1:
        raise ValueError("hp_join arguments must share one device")
    if not all(t.is_contiguous() for t in (keys, vals, us, vs)):
        raise ValueError("hp_join arguments must be contiguous")


def hp_join(keys: torch.Tensor, vals: torch.Tensor, us: torch.Tensor,
            vs: torch.Tensor) -> torch.Tensor:
    """(B,) float32 pair scores. On a CUDA device the Hopper kernel runs
    (it raises if it cannot be built or launched); for CPU tensors the
    plain version runs. ``hp_join.launches`` counts kernel launches."""
    _check(keys, vals, us, vs)
    if keys.device.type == "cpu":
        return hp_join_plain(keys, vals, us, vs)
    out = torch.empty(us.shape[0], dtype=torch.float32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _launcher()(keys.data_ptr(), vals.data_ptr(), us.data_ptr(),
                      vs.data_ptr(), us.shape[0], keys.shape[1],
                      out.data_ptr(), stream)
    _build.check(err, "hp_join")
    hp_join.launches += 1
    return out


hp_join.launches = 0
