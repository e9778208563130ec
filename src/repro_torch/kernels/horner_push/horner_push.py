"""The Horner steps of a push, each ``out = seed_l + Â · prune_tau(x)``
for l = l_max .. 0: the Hopper kernel's wrapper and its plain PyTorch
version.

Replaces the TPU kernel ``src/repro/kernels/horner_push/horner_push.py``
(``_step_kernel`` / ``horner_step``). Frontiers are node-major (n, B)
float32; Â is given in CSR over destinations (``in_ptr``,
``in_idx``, per-edge ``w``) with the nodes split into light and heavy
in-degree classes (``ops.PushLayout``); the seed of level
l places ``contrib[b, j]`` at node ``k`` for every entry whose key
``keys[b, j]`` equals ``l*n + k``, with duplicate keys adding up.
``keys`` rows must be sorted ascending (``ops.prepare_rows`` sorts
them). The kernel (``csrc/horner_push.cu``) sums each output inside
one block in a fixed order -- one thread per output for light nodes,
one block per heavy node -- with no atomics. The wrapper launches the
l_max + 1 steps from one host call (``horner_steps_launch``), so the
host's per-launch cost is paid in C, not in Python.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hp_index import INT32_PAD_KEY, pull
from repro_torch.kernels import _build

_launch = []   # the bound C function, filled on first launch


def _launcher():
    if not _launch:
        fn = _build.load("horner_push").horner_steps_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [i32, ptr, i32, ptr, ptr] + [i32] * 4 \
            + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


def horner_step_plain(x, out, layout, keys, contrib, level: int,
                      tau: float) -> torch.Tensor:
    """One plain step: prune, CSR pull (``hp_index.pull``), and the
    level-l seed scattered with ``index_add_``; written into ``out``."""
    n, B = x.shape
    acc = pull(torch.where(x > tau, x, 0.0), layout.in_ptr.long(),
               layout.in_idx, layout.w)
    hit = (keys != INT32_PAD_KEY) & (keys.long() // n == level)
    b_idx, j_idx = torch.nonzero(hit, as_tuple=True)
    seed = torch.zeros(n * B, dtype=torch.float32, device=x.device)
    seed.index_add_(0, (keys[b_idx, j_idx].long() % n) * B + b_idx,
                    contrib[b_idx, j_idx])
    return out.copy_(acc + seed.view(n, B))


def horner_steps_plain(acc, spare, layout, keys, contrib, l_max: int,
                       tau: float) -> torch.Tensor:
    """The plain version of :func:`horner_steps`: the same ping-pong over
    levels l_max .. 0 with :func:`horner_step_plain`."""
    for level in range(l_max, -1, -1):
        horner_step_plain(acc, spare, layout, keys, contrib, level, tau)
        acc, spare = spare, acc
    return acc


def _check(x, out, layout, keys, contrib) -> None:
    n, B = x.shape
    lay = (layout.in_ptr, layout.in_idx, layout.w, layout.heavy,
           layout.light)
    if out.shape != (n, B) or layout.n != n or \
            layout.in_ptr.shape != (n + 1,) or \
            layout.w.shape != layout.in_idx.shape or \
            layout.heavy.numel() + layout.light.numel() != n or \
            keys.dim() != 2 or keys.shape[0] != B or \
            contrib.shape != keys.shape:
        raise ValueError(
            f"horner_steps shapes: x {tuple(x.shape)} out "
            f"{tuple(out.shape)} layout n={layout.n} keys "
            f"{tuple(keys.shape)} contrib {tuple(contrib.shape)}")
    if any(t.dtype != torch.float32 for t in (x, out, layout.w, contrib)) \
            or any(t.dtype != torch.int32 for t in lay[:2] + lay[3:]) \
            or keys.dtype != torch.int32:
        raise TypeError("horner_steps takes float32 x/out/w/contrib and "
                        "int32 keys and layout indices")
    ts = (x, out, keys, contrib) + lay
    if len({t.device for t in ts}) != 1:
        raise ValueError("horner_steps arguments must share one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("horner_steps arguments must be contiguous")


def horner_steps(acc, spare, layout, keys, contrib, l_max: int,
                 tau: float) -> torch.Tensor:
    """Run levels l_max .. 0 from the frontier ``acc`` (node-major
    (n, B)), ping-ponging ``acc`` and ``spare``; returns the buffer that
    holds the result. On a CUDA device the Hopper kernel runs, one
    launch per level (it raises if it cannot be built or launched); for
    CPU tensors the plain version runs. ``horner_steps.launches`` counts
    kernel launches."""
    _check(acc, spare, layout, keys, contrib)
    if acc.device.type == "cpu":
        return horner_steps_plain(acc, spare, layout, keys, contrib, l_max,
                                  tau)
    n, B = acc.shape
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    err = _launcher()(acc.data_ptr(), spare.data_ptr(),
                      layout.in_ptr.data_ptr(), layout.in_idx.data_ptr(),
                      layout.w.data_ptr(), layout.heavy.data_ptr(),
                      layout.heavy.numel(), layout.light.data_ptr(),
                      layout.light.numel(), keys.data_ptr(),
                      contrib.data_ptr(), n, B, keys.shape[1], l_max, tau,
                      stream)
    _build.check(err, "horner_steps")
    horner_steps.launches += l_max + 1
    return spare if (l_max + 1) % 2 else acc


horner_steps.launches = 0
