"""The SLING single-source push from row ids to scores: the Hopper
kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/horner_push/horner_push.py``
(``_step_kernel`` / ``horner_step``) and the Horner loop that drives it
(``src/repro/kernels/horner_push/ops.py``). Both versions compute, for
the rows ``us`` of a packed table ``keys``/``vals`` (N, W) whose rows
are sorted by key = l*n + k with PAD last,

    acc = 0;  for l = l_max .. 0:  acc = Â prune_tau(acc) + seed_l
    seed_l[k, b] = sum of vals[us[b], j] * d[k] over the entries j of
                   row us[b] with key l*n + k (duplicate keys add up)

and return the (B, n) float32 scores; Â is given in CSR over
destinations (``SpmmLayout``). The kernel (``csrc/horner_push.cu``)
runs the whole push in one persistent cooperative launch: it reads the
rows through ``us`` itself, finds each row's level runs in a prologue,
starts at the highest level that holds a seed, and writes level 0
straight into the result. The host only allocates the result and one
workspace. Each output is summed in a fixed order with no atomics, so
two pushes give the same bits.

The node-sharded push (``core/shard_query.py``) cannot run a
collective inside that launch, so it launches a second entry of the
same source once per level per shard: :func:`horner_push_slab_step`,
one level on one node slab from the gathered frontier, with
:func:`~repro_torch.kernels.horner_push.ops.horner_slab_step_plain` as
its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.horner_push.ops import (horner_push,
                                                 horner_slab_step_plain)

_launch = []   # the bound C functions, filled on first launch
_slab_launch = []


def _launcher():
    if not _launch:
        lib = _build.load("horner_push")
        fn = lib.horner_push_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 4 + [i32] * 3 + [ptr] * 4 + [i32] * 6
                       + [ctypes.c_float] + [ptr] * 3)
        fn.restype = ctypes.c_int
        lib.horner_push_grid.argtypes = [i32] * 6
        lib.horner_push_grid.restype = ctypes.c_longlong
        _launch.extend([fn, lib.horner_push_grid])
    return _launch[0]


def persistent_grid(layout, batch: int) -> int:
    """The blocks (of 1,024 threads) that the kernel launches for a push
    of ``batch`` columns over ``layout`` on the current card."""
    _launcher()
    grid = _launch[1](*layout.push_tiers, batch,
                      4 if batch % 4 == 0 else 1)
    if grid < 0:
        _build.check(int(-grid), "horner_push_grid")
    return int(grid)


def workspace_numel(n: int, batch: int, l_max: int) -> int:
    """32-bit words of the kernel's scratch: two (n, B) frontiers, two
    (n, B) seed-staging buffers and the (B, l_max + 3) level runs. It
    may hold anything when the kernel starts."""
    return 4 * n * batch + batch * (l_max + 3)


def horner_push_rows_plain(keys, vals, d, us, layout, tau: float, *,
                           l_max: int) -> torch.Tensor:
    """The plain version of :func:`horner_push_rows`: gather the rows,
    then :func:`~repro_torch.kernels.horner_push.ops.horner_push`."""
    ids = us.long()
    return horner_push(keys[ids], vals[ids], d, layout, tau, n=layout.n,
                       l_max=l_max)


def _check(keys, vals, d, us, layout, l_max, workspace) -> None:
    """The per-call arguments against the layout (whose own arrays
    :class:`SpmmLayout` checked when it was made)."""
    n = layout.n
    if keys.dim() != 2 or vals.shape != keys.shape or d.shape != (n,) \
            or us.dim() != 1 or l_max < 0:
        raise ValueError(
            f"horner_push_rows shapes: keys {tuple(keys.shape)} vals "
            f"{tuple(vals.shape)} d {tuple(d.shape)} us {tuple(us.shape)} "
            f"layout n={n} l_max={l_max}")
    if keys.dtype != torch.int32 or vals.dtype != torch.float32 or \
            d.dtype != torch.float32 or \
            us.dtype not in (torch.int32, torch.int64):
        raise TypeError("horner_push_rows takes int32 keys, float32 "
                        "vals/d and int32 or int64 row ids")
    ts = (keys, vals, d, us) + (() if workspace is None else (workspace,))
    if any(t.device != layout.device for t in ts):
        raise ValueError("horner_push_rows arguments must share the "
                         "layout's device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("horner_push_rows arguments must be contiguous")
    if workspace is not None and (
            workspace.dtype != torch.float32 or workspace.numel() <
            workspace_numel(n, us.shape[0], l_max)):
        raise ValueError("horner_push_rows workspace must be float32 of "
                         "at least workspace_numel(n, B, l_max) words")


def horner_push_rows(keys, vals, d, us, layout, tau: float, *, l_max: int,
                     workspace=None) -> torch.Tensor:
    """(B, n) float32 scores of the rows ``us`` (int32 or int64, each in
    [0, N)) of the packed table ``keys``/``vals`` (N, W), rows sorted
    with PAD last. On a CUDA device the Hopper kernel runs the whole
    push in one cooperative launch (it raises if it cannot be built or
    launched, or the card refuses the launch); nothing runs before it
    but the allocation of the result and of the workspace, which the
    caller may pass instead (``workspace_numel`` words, any contents).
    For CPU tensors the plain version runs.
    ``horner_push_rows.launches`` counts kernel launches (one a push),
    ``horner_push_rows.steps`` the levels they cover (l_max + 1 a
    push)."""
    _check(keys, vals, d, us, layout, l_max, workspace)
    if keys.device.type == "cpu":
        return horner_push_rows_plain(keys, vals, d, us, layout, tau,
                                      l_max=l_max)
    n, B = layout.n, us.shape[0]
    out = torch.empty((B, n), dtype=torch.float32, device=keys.device)
    if B == 0 or n == 0:
        return out
    if workspace is None:
        workspace = torch.empty(workspace_numel(n, B, l_max),
                                dtype=torch.float32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _launcher()(keys.data_ptr(), vals.data_ptr(), d.data_ptr(),
                      us.data_ptr(), int(us.dtype == torch.int64), B,
                      keys.shape[1], layout.in_ptr.data_ptr(),
                      layout.in_idx.data_ptr(), layout.w.data_ptr(),
                      layout.push_order.data_ptr(), *layout.push_tiers, n,
                      l_max, tau, workspace.data_ptr(), out.data_ptr(),
                      stream)
    _build.check(err, "horner_push_rows")
    with _build.counter_lock:
        horner_push_rows.launches += 1
        horner_push_rows.steps += l_max + 1
    return out


horner_push_rows.launches = 0
horner_push_rows.steps = 0


def _slab_launcher():
    if not _slab_launch:
        fn = _build.load("horner_push").horner_slab_step_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 5 + [i32] * 4 + [ptr] * 4 + [i32] * 8
                       + [ctypes.c_float, ptr, ptr])
        fn.restype = ctypes.c_int
        _slab_launch.append(fn)
    return _slab_launch[0]


def _check_slab(x, layout, keys, vals, runs, d, level, l_max, n,
                slab_start, d_offset, out) -> None:
    n_loc, B = layout.n, keys.shape[0]
    if keys.dim() != 2 or vals.shape != keys.shape or d.dim() != 1 \
            or runs.shape != (B, l_max + 2) or not 0 <= level <= l_max \
            or (x is not None and (x.dim() != 2 or x.shape[1] != B)) \
            or (out is not None and out.shape != (n_loc, B)) \
            or not 0 <= slab_start - d_offset \
            or min(n, slab_start + n_loc) - d_offset > d.shape[0]:
        raise ValueError(
            f"horner_push_slab_step shapes: x "
            f"{None if x is None else tuple(x.shape)} keys "
            f"{tuple(keys.shape)} vals {tuple(vals.shape)} runs "
            f"{tuple(runs.shape)} d {tuple(d.shape)} level {level} l_max "
            f"{l_max} slab [{slab_start}, +{n_loc}) d_offset {d_offset}")
    if keys.dtype != torch.int32 or runs.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (vals, d, x, out)
            if t is not None):
        raise TypeError("horner_push_slab_step takes int32 keys and runs, "
                        "float32 x, vals, d and out")
    ts = [t for t in (x, keys, vals, runs, d, out) if t is not None]
    if any(t.device != layout.device for t in ts):
        raise ValueError("horner_push_slab_step arguments must share the "
                         "layout's device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("horner_push_slab_step arguments must be "
                         "contiguous")
    if x is not None and out is not None and \
            x.data_ptr() == out.data_ptr():
        raise ValueError("horner_push_slab_step writes out apart from x")


def horner_push_slab_step(x, layout, keys, vals, runs, d, level: int,
                          tau: float, *, n: int, slab_start: int,
                          d_offset: int, l_max: int,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """One Horner level on the node slab [slab_start, slab_start +
    layout.n) of an n-node graph: (n_loc, B) float32,

        out[v, b] = sum_{e in I(v)} w_e * prune_tau(x[src_e, b])
                    + sum of vals[b, j] * d[slab_start + v - d_offset]
                      over the entries j of row b with key
                      level * n + slab_start + v,

    ``x`` the gathered node-major frontier (rows, B) that the layout's
    global ``in_idx`` address (None at the first level of a push: zero),
    ``keys``/``vals``/``runs`` the query rows as ``ops.slab_rows``
    prepares them. On a CUDA device the Hopper kernel runs (it raises
    if it cannot be built or launched); for CPU tensors the plain
    version runs. ``horner_push_slab_step.launches`` counts kernel
    launches (one a level a shard)."""
    tau = ctypes.c_float(tau).value      # the kernel compares in float32
    _check_slab(x, layout, keys, vals, runs, d, level, l_max, n,
                slab_start, d_offset, out)
    if keys.device.type == "cpu":
        return horner_slab_step_plain(x, layout, keys, vals, d, level, tau,
                                      n=n, slab_start=slab_start,
                                      d_offset=d_offset, out=out)
    n_loc, B = layout.n, keys.shape[0]
    if out is None:
        out = torch.empty((n_loc, B), dtype=torch.float32,
                          device=keys.device)
    if B == 0 or n_loc == 0:
        return out
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = _slab_launcher()(
            None if x is None else x.data_ptr(), layout.in_ptr.data_ptr(),
            layout.in_idx.data_ptr(), layout.w.data_ptr(),
            layout.push_order.data_ptr(), *layout.push_tiers,
            keys.data_ptr(), vals.data_ptr(), runs.data_ptr(),
            d.data_ptr(), B, keys.shape[1], n, n_loc, slab_start, d_offset,
            l_max, level, tau, out.data_ptr(), stream)
    _build.check(err, "horner_push_slab_step")
    with _build.counter_lock:
        horner_push_slab_step.launches += 1
    return out


horner_push_slab_step.launches = 0
