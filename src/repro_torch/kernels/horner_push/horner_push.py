"""The SLING Horner push from query ids to scores: the Hopper kernel's
wrappers and their plain PyTorch versions.

Replaces the TPU kernel ``src/repro/kernels/horner_push/horner_push.py``
(``_step_kernel`` / ``horner_step``) and the Horner loop that drives it
(``src/repro/kernels/horner_push/ops.py``), in its single-device role and
in its sharded one (one level on one node slab, the frontier
all-gathered outside it). The push computes, for the query rows of a
packed table whose rows are sorted by key = l*n + k with PAD last,

    acc = 0;  for l = l_max .. 0:  acc = Â prune_tau(acc) + seed_l
    seed_l[k, b] = sum of vals[u_b, j] * d[k] over the entries j of
                   query b's row with key l*n + k (duplicate keys add up)

with Â given in CSR over destinations (``SpmmLayout``). One kernel
(``csrc/horner_push.cu``) runs it in one persistent cooperative launch
over the node slabs that lie on a device; it reads the rows through the
ids itself, finds each row's level runs in a prologue, starts at the
highest level that holds a seed, and writes level 0 straight into the
result. Each output is summed in a fixed order with no atomics, so two
pushes give the same bits. Two wrappers launch it:

  * :func:`horner_push_rows` -- a single-source push: one slab of all n
    nodes, the table as the row source, the (B, n) scores;
  * :func:`horner_push_slabs` -- a node-sharded push: up to
    ``MAX_SLABS`` slabs of one device, a row source of table segments,
    a range of levels, each slab's (n_loc, B) result and the shared
    node-major frontier in a caller's workspace
    (``core/single_source.py`` drives it: every level in one launch
    where every slab lies on one device, one level a launch a device on
    a mesh of several).

:func:`horner_push_cost` counts either call's work. On ``FakeTensor``
inputs (the dry run) a wrapper makes its outputs empty and records that
cost (``kernels/cost.py``), every row slot taken as live and every
level of its range as run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.horner_push.ops import (MAX_SEGMENTS, MAX_SLABS,
                                                 horner_push,
                                                 horner_push_slabs_plain)

_launch = []   # the bound C functions, filled on first launch


def _launcher():
    if not _launch:
        lib = _build.load("horner_push")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        push = lib.horner_push_launch
        push.argtypes = ([ptr, ptr, i64, ptr, ptr] + [i32] * 3 + [ptr] * 4
                         + [i32] * 6 + [ctypes.c_float] + [ptr] * 3)
        push.restype = i32
        slabs = lib.horner_push_slabs_launch
        slabs.argtypes = ([i32, ptr, ptr, i32, ptr, i32, ptr] + [i32] * 3
                          + [i64] + [i32] * 5 + [ctypes.c_float, ptr, ptr])
        slabs.restype = i32
        lib.horner_push_grid.argtypes = [i32, ptr, i32, i32]
        lib.horner_push_grid.restype = i64
        _launch.extend([push, slabs, lib.horner_push_grid])
    return _launch


def _grid(tiers: list, batch: int) -> int:
    grid_fn = _launcher()[2]
    arr = (ctypes.c_int * len(tiers))(*tiers)
    grid = grid_fn(len(tiers) // 4, arr, batch, 4 if batch % 4 == 0 else 1)
    if grid < 0:
        _build.check(int(-grid), "horner_push_grid")
    return int(grid)


def persistent_grid(layout, batch: int) -> int:
    """The blocks (of 1,024 threads) that the kernel launches for a push
    of ``batch`` columns over ``layout`` on the current card."""
    return _grid(list(layout.push_tiers), batch)


def slabs_grid(slabs, batch: int) -> int:
    """The blocks that :func:`horner_push_slabs` launches over ``slabs``
    for ``batch`` columns on the current card."""
    return _grid([t for sl in slabs for t in sl.layout.push_tiers], batch)


def workspace_numel(n: int, batch: int, l_max: int) -> int:
    """32-bit words of the kernel's scratch over ``n`` frontier rows: two
    (n, B) node-major frontiers, two (n, B) seed-staging buffers and the
    (B, l_max + 3) level runs."""
    return 4 * n * batch + batch * (l_max + 3)


def frontier_view(workspace: torch.Tensor, n_rows: int,
                  batch: int) -> torch.Tensor:
    """The two node-major frontiers (2, n_rows, B) at the head of a
    workspace: level l of a push writes ``[l & 1]``."""
    return workspace[:2 * n_rows * batch].view(2, n_rows, batch)


def horner_push_cost(batch: int, live: int, edges: int, csr_rows: int,
                     out_rows: int, levels: int,
                     id_bytes: int = 8) -> _cost.KernelCost:
    """The work of one push of ``batch`` query rows holding ``live``
    entries, over a CSR of ``edges`` edges in ``csr_rows`` row pointers,
    into ``out_rows`` result rows, for the ``levels`` that run. Bytes,
    each read or written once: the ids, every live entry's key, value
    and d at its target (12 bytes), the CSR (index and weight an edge, a
    pointer a row) and the (out_rows, batch) float32 result; operations:
    a multiply-add an edge and a column in each level that runs."""
    return _cost.KernelCost(
        bytes=id_bytes * batch + 12.0 * live + 8.0 * edges + 4.0 * csr_rows
        + 4.0 * out_rows * batch,
        flops=2.0 * levels * edges * batch)


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
    For CPU tensors the plain version runs; for fake tensors nothing
    runs (the module docstring).
    ``horner_push_rows.launches`` counts kernel launches (one a push),
    ``horner_push_rows.steps`` the levels they cover (l_max + 1 a
    push)."""
    _check(keys, vals, d, us, layout, l_max, workspace)
    if _cost.is_fake(keys, vals, us):
        return _fake_rows(keys, us, layout, l_max, workspace)
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
    err = _launcher()[0](
        keys.data_ptr(), vals.data_ptr(), keys.shape[0], d.data_ptr(),
        us.data_ptr(), int(us.dtype == torch.int64), B, keys.shape[1],
        layout.in_ptr.data_ptr(), layout.in_idx.data_ptr(),
        layout.w.data_ptr(), layout.push_order.data_ptr(),
        *layout.push_tiers, n, l_max, tau, workspace.data_ptr(),
        out.data_ptr(), stream)
    _build.check(err, "horner_push_rows")
    with _build.counter_lock:
        horner_push_rows.launches += 1
        horner_push_rows.steps += l_max + 1
    return out


horner_push_rows.launches = 0
horner_push_rows.steps = 0


def _fake_rows(keys, us, layout, l_max, workspace) -> torch.Tensor:
    """:func:`horner_push_rows` on fake tensors: the result and the
    workspace the kernel allocates, and one recorded launch, every slot
    of the B rows live and all l_max + 1 levels run."""
    n, B = layout.n, us.shape[0]
    out = torch.empty((B, n), dtype=torch.float32, device=keys.device)
    if workspace is None:
        workspace = torch.empty(workspace_numel(n, B, l_max),
                                dtype=torch.float32, device=keys.device)
    _cost.worst_case("horner_push_rows: every slot of the B query rows "
                     "live, all l_max + 1 levels run")
    _cost.record("horner_push_rows", horner_push_cost(
        B, B * keys.shape[1], layout.in_idx.numel(), n + 1, n, l_max + 1,
        us.element_size()), keys.device, out=(out, workspace))
    return out


def _check_caps(slabs, rows) -> None:
    """The kernel's parameter table holds at most ``MAX_SLABS`` slabs and
    ``MAX_SEGMENTS`` row segments; the plain version has no such cap."""
    if len(slabs) > MAX_SLABS:
        raise ValueError(
            f"horner_push_slabs takes 1 to {MAX_SLABS} slabs a launch, got "
            f"{len(slabs)}: cut the node dimension into fewer slabs a "
            "device")
    if len(rows) > MAX_SEGMENTS:
        raise ValueError(f"horner_push_slabs takes at most {MAX_SEGMENTS} "
                         f"row segments, got {len(rows)}")


def _check_slabs(rows, us, slabs, outs, n, l_max, hi, lo, n_rows,
                 workspace) -> None:
    if not slabs:
        raise ValueError("horner_push_slabs takes at least one slab")
    B = us.shape[0]
    dev = slabs[0].layout.device
    width = {k.shape[1] for k, _, _ in rows}
    if us.dim() != 1 or len(outs) != len(slabs) or len(width) > 1 \
            or not 0 <= lo <= hi <= l_max or n <= 0 \
            or (l_max + 1) * n > 0x7fffffff or n_rows > 0x7fffffff \
            or any(k.dim() != 2 or v.shape != k.shape for k, v, _ in rows) \
            or any(o.shape != (sl.layout.n, B) for sl, o in zip(slabs, outs))\
            or any(sl.start + sl.layout.n > n_rows
                   or min(n, sl.start + sl.layout.n) - sl.d_offset
                   > sl.d.shape[0] for sl in slabs):
        raise ValueError(
            f"horner_push_slabs shapes: {len(slabs)} slabs "
            f"{[(sl.start, sl.layout.n, sl.d_offset) for sl in slabs]} of "
            f"{n_rows} rows, outs {[tuple(o.shape) for o in outs]}, rows "
            f"{[tuple(k.shape) for k, _, _ in rows]}, us {tuple(us.shape)}"
            f", levels [{hi} .. {lo}] of l_max {l_max}, n {n}")
    if any(k.dtype != torch.int32 or v.dtype != torch.float32
           for k, v, _ in rows) or us.dtype not in (torch.int32,
                                                    torch.int64) \
            or any(o.dtype != torch.float32 for o in outs):
        raise TypeError("horner_push_slabs takes int32 keys, float32 vals "
                        "and outs, and int32 or int64 ids")
    # a Slab checked its layout and d when it was made
    ts = [us, *outs, *(t for k, v, _ in rows for t in (k, v)),
          *(sl.layout.in_ptr for sl in slabs[1:])]
    if workspace is not None:
        ts.append(workspace)
    if any(t.device != dev for t in ts):
        raise ValueError("horner_push_slabs arguments must share the "
                         "slabs' device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("horner_push_slabs arguments must be contiguous")
    if workspace is not None and (
            workspace.dtype != torch.float32 or workspace.numel() <
            workspace_numel(n_rows, B, l_max)):
        raise ValueError("horner_push_slabs workspace must be float32 of "
                         "at least workspace_numel(n_rows, B, l_max) words")


def horner_push_slabs(rows, us, slabs, outs, tau: float, *, n: int,
                      l_max: int, hi: int | None = None, lo: int = 0,
                      bf16_frontier: bool = False,
                      n_rows: int | None = None,
                      workspace: torch.Tensor | None = None) -> None:
    """The levels ``hi`` (default l_max) .. ``lo`` of the Horner push of
    the query ids ``us`` (B,) over node slabs of an ``n``-node graph that
    lie on one device, in one launch.

    ``slabs``: up to ``MAX_SLABS`` :class:`~repro_torch.kernels.
    horner_push.ops.Slab` -- the rows [start, start + layout.n) of the
    node dimension, their in-edges (``layout``, sources global rows of
    the frontier), d read at k - d_offset. ``rows``: the row source, a
    list of segments (keys, vals, base), each a packed table (rows
    sorted by key, PAD last) of the ids [base, base + len(keys)); an id
    no segment holds is an empty row. ``outs``: each slab's (n_loc, B)
    float32 result, written by level 0. ``workspace``
    (``workspace_numel(n_rows, B, l_max)`` float32, allocated when not
    given) holds the two node-major (n_rows, B) frontiers
    (:func:`frontier_view`; ``n_rows`` defaults to the slabs' last row):
    level l writes every slab's rows of buffer l & 1 at their global
    rows, so on one device the frontier is gathered where it is written.
    A launch below the push's top level reads level hi + 1 from there.
    The highest level holding a seed is found inside the launch; above
    it the push is exactly zero and nothing runs. ``bf16_frontier``
    rounds every frontier value through bfloat16 (level 0's result
    stays float32). On a CUDA device the Hopper kernel runs (it raises
    if it cannot be built or launched, or above the slab cap; it never
    falls back); for CPU tensors the plain version runs, for fake ones
    nothing (the module docstring). ``horner_push_slabs.launches``
    counts kernel launches."""
    tau = ctypes.c_float(tau).value      # the kernel compares in float32
    hi = l_max if hi is None else hi
    if n_rows is None:
        n_rows = max(sl.start + sl.layout.n for sl in slabs)
    _check_slabs(rows, us, slabs, outs, n, l_max, hi, lo, n_rows, workspace)
    dev = slabs[0].layout.device
    kw = dict(n=n, l_max=l_max, hi=hi, lo=lo, bf16_frontier=bf16_frontier,
              n_rows=n_rows, workspace=workspace)
    if dev.type == "cpu" and not _cost.is_fake(us, *outs):
        horner_push_slabs_plain(rows, us, slabs, outs, tau, **kw)
        return
    _check_caps(slabs, rows)
    B = us.shape[0]
    if _cost.is_fake(us, *outs):
        if workspace is None:
            workspace = torch.empty(workspace_numel(n_rows, B, l_max),
                                    dtype=torch.float32, device=dev)
        _cost.worst_case("horner_push_slabs: every slot of the B query "
                         "rows live, every level of the launch's range run")
        _cost.record("horner_push_slabs", horner_push_cost(
            B, B * (rows[0][0].shape[1] if rows else 0),
            sum(sl.layout.in_idx.numel() for sl in slabs),
            sum(sl.layout.n + 1 for sl in slabs),
            sum(sl.layout.n for sl in slabs), hi - lo + 1,
            us.element_size()), dev, out=(*outs, workspace))
        return
    if B == 0:
        return
    if workspace is None:
        workspace = torch.empty(workspace_numel(n_rows, B, l_max),
                                dtype=torch.float32, device=dev)
    ptrs, ints = [], []
    for sl, out in zip(slabs, outs):
        lay = sl.layout
        ptrs += [lay.in_ptr.data_ptr(), lay.in_idx.data_ptr(),
                 lay.w.data_ptr(), lay.push_order.data_ptr(),
                 sl.d.data_ptr(), out.data_ptr()]
        ints += [sl.start, lay.n, sl.d_offset, *lay.push_tiers]
    segs = [x for k, v, base in rows
            for x in (k.data_ptr(), v.data_ptr(), int(base), k.shape[0])]
    width = rows[0][0].shape[1] if rows else 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()[1](
            len(slabs), (ctypes.c_longlong * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints), len(rows),
            (ctypes.c_longlong * max(len(segs), 1))(*segs), width,
            us.data_ptr(), int(us.dtype == torch.int64), B, n, n_rows,
            l_max, hi, lo, 0, int(bf16_frontier), tau,
            workspace.data_ptr(), stream)
    _build.check(err, "horner_push_slabs")
    with _build.counter_lock:
        horner_push_slabs.launches += 1


horner_push_slabs.launches = 0
