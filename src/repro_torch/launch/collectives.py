"""Collectives over a mesh's positions, run from one thread, and the
classes of equal positions that a dry run traces once each.

A partitioned step (``models/transformer_sharded.py``) is one program a
mesh position, run position by position in row-major order. Where the
positions exchange data it calls a collective here on {position:
tensor} dicts, the counterparts of the all-gather, reduce-scatter and
all-reduce that GSPMD derives for the reference. A collective names its
group by mesh axes: the peers of a position over ``axes`` are the
positions equal to it on every other axis, row-major (:func:`peers`).

  * :func:`all_gather`: every member assembles its peers' parts, each at
    its region of the result (``region(q)``: one (lo, hi) a dimension),
    cast to ``dtype``. Differentiable: the backward is the
    reduce-scatter, each part's gradient the sum of its readers'
    gradients at its region, in row-major position order, in float32,
    cast once to the part's dtype. ``readers`` widens the readers past
    the gather's own group: a weight replicated over an axis sums its
    gradient over that axis too, so every copy gets the same sum.
  * :func:`reduce_scatter`: the all-gather's backward run forward:
    every member gets the sum of its peers' parts at its own region, in
    row-major order, in float32, cast once. Its backward is the
    all-gather.
  * :func:`all_reduce`: every member gets the sum (or the maximum) of
    its peers' parts, ring-style: the parts, flattened, are cut into one
    chunk a member, member i reduces chunk i over the group in row-major
    order, in float32, casts it once, and every member gathers the
    reduced chunks; each member moves about twice its part's bytes, not
    the group's. Differentiable when it sums (the sum is its own
    adjoint).
  * ``reduce_scatter(op="max", counts=)``: every member gets the
    maximum of its peers' parts at its region. With ``counts`` (each
    part's count of the entries it took its maximum over that equal it,
    its local ties) it is differentiable as one maximum over the whole
    segment is: the gradient goes equally to every tied entry across the
    members. Each member's share of an output entry is g / K where it
    holds the maximum (K the tied entries of every member), and the
    member's own local maximum passes that share on to each of its tied
    entries undivided (``models/gnn_sharded.py``'s ``_TiedMax``): g / K
    is the division one ``scatter_reduce("amax")`` over the whole
    segment makes, so the entries get its bits.

A step whose exchanged tensors are large runs one position at a time:
:func:`gather_at` assembles one position's whole tensor (its backward
sends each peer the gradient at the peer's region, which autograd adds
into the peer's gradient), and :class:`ScatterSum` is a reduce-scatter
fed one position's part at a time, each part added at once into its
peers' float32 sums at their regions (in the order the parts come,
row-major when the caller feeds ``S.run`` in order) and then free, its
backward the all-gather. On one device that holds every position, one
position's whole tensors are live at a time, not the group's.

A sum or a maximum "in float32" is formed in float64 where the parts
are float64. On real tensors these are plain torch copies (a part
already on the member's device is not moved) and arithmetic, named for
the op walk
with ``kernels/cost.collective``. On fake tensors (the dry run's) they
copy nothing: each makes its results with ``torch.empty`` and books
every taking-part device's bytes sent and received through
``kernels/cost.record_collective``, as the real copies count them (an
all-gather's part moves once to each peer on another device).

A dry run on distinct fake devices runs two programs for each class of
positions whose programs are equal (:func:`spmd`): the caller keys each
position by everything its program's shapes depend on, and the first
and the last position of a class, row-major, run for it (a position's
peak memory depends on whether its turn comes first, in the middle or
last in the loops over positions, and the middle one's is the least). The collectives book the
bytes of the positions that run from the regions of every position, so
each device that runs gets the totals that a trace of every position
gives it; the other devices hold their arguments and do no work.
:func:`every_position` turns the shortcut off. The one-position forms
copy and add on fakes too where a peer shares the device (a mesh that
repeats a device runs every position, so the walk sees the copies and
the sums that the real run makes there) and book the bytes of every
other peer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from repro_torch.kernels import cost as _cost

_SHORTCUT = [True]


@contextlib.contextmanager
def every_position():
    """Inside the block a fake step runs every position's program."""
    prev = _SHORTCUT[0]
    _SHORTCUT[0] = False
    try:
        yield
    finally:
        _SHORTCUT[0] = prev


@dataclasses.dataclass(frozen=True)
class Spmd:
    """A mesh, the positions whose programs run (row-major), and whether
    the tensors are fake."""
    mesh: Any
    run: tuple
    fake: bool

    def dev(self, pos) -> torch.device:
        return _devices(self.mesh)[pos]


@functools.lru_cache(maxsize=None)
def _devices(mesh) -> dict:
    """{position: device} of ``mesh``."""
    grid = mesh.devices
    return {p: grid[p] for p in positions(mesh)}


def positions(mesh) -> tuple:
    """Every position of ``mesh``, row-major."""
    return tuple(mesh.axes_positions(mesh.axis_names))


def spmd(mesh, key: Callable, fake: bool) -> Spmd:
    """The positions to run: every one on real tensors; on fake tensors
    over distinct devices, the first and the last position of each class
    of equal ``key(position)``."""
    every = positions(mesh)
    if not (fake and _SHORTCUT[0] and len(set(mesh.flat)) == len(mesh.flat)):
        return Spmd(mesh, every, fake)
    ends: dict = {}
    for p in every:
        k = key(p)
        ends[k] = (ends.get(k, (p,))[0], p)
    return Spmd(mesh, tuple(sorted({p for e in ends.values() for p in e})),
                fake)


@functools.lru_cache(maxsize=None)
def peers(mesh, pos: tuple, axes: tuple) -> tuple:
    """The positions equal to ``pos`` off ``axes``, row-major over the
    mesh's axes among ``axes`` (``pos`` alone when there are none)."""
    axes = tuple(a for a in mesh.axis_names if a in axes)
    coords = {a: pos[i] for i, a in enumerate(mesh.axis_names)
              if a not in axes}
    return tuple(mesh.axes_positions(axes, **coords))


def group_index(mesh, pos: tuple, axes) -> tuple[int, int]:
    """(the row-major index of ``pos`` among its peers over ``axes``, the
    number of peers)."""
    k, i = 1, 0
    for n, a in enumerate(mesh.axis_names):
        if a in axes:
            k, i = k * mesh.dims[n], i * mesh.dims[n] + pos[n]
    return i, k


def _acc(dtype) -> torch.dtype:
    """The dtype a collective sums or takes a maximum in: float64 for
    float64 parts, float32 for any other."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _nbytes(region, dtype) -> int:
    return math.prod(hi - lo for lo, hi in region) * dtype.itemsize


def _slices(region) -> tuple:
    return tuple(slice(lo, hi) for lo, hi in region)


@dataclasses.dataclass(frozen=True)
class _GatherOp:
    S: Spmd
    axes: tuple
    readers: tuple
    region: Callable
    shape: Callable
    dtype: Any
    what: str

    def forward(self, parts):
        S, mesh = self.S, self.S.mesh
        by = dict(zip(S.run, parts))
        outs = []
        for p in S.run:
            dev, dt = S.dev(p), self.dtype or by[p].dtype
            out = torch.empty(self.shape(p), dtype=dt, device=dev)
            group = peers(mesh, p, self.axes)
            if S.fake:
                recv = sum(_nbytes(self.region(q), dt)
                           for q in group if S.dev(q) != dev)
                sent = sum(S.dev(q) != dev for q in group) \
                    * _nbytes(self.region(p), dt)
                _cost.record_collective("all-gather", dev, sent, recv,
                                        self.what, out.shape, dt)
            else:
                with _cost.collective("all-gather"):
                    for q in group:
                        out[_slices(self.region(q))] = by[q]
            outs.append(out)
        return outs

    def backward(self, grads, metas):
        return _scatter_sum(self.S, grads, self.readers, self.region,
                            [self.dtype or dt for dt, _, _ in metas],
                            metas, self.what)


def _scatter_sum(S: Spmd, parts, axes, region, wire, metas, what):
    """[q's peers' parts over ``axes`` summed at ``region(q)``] for each
    position q of ``S.run``, in row-major order, in float32, cast once
    to q's dtype of ``metas`` [(dtype, shape, device)]; on fakes booked
    as a reduce-scatter of ``wire`` dtypes."""
    mesh = S.mesh
    by = dict(zip(S.run, parts))
    res = []
    for q, wdt, (dt, shp, dev) in zip(S.run, wire, metas):
        group = peers(mesh, q, axes)
        if S.fake:
            recv = sum(S.dev(p) != dev for p in group) \
                * _nbytes(region(q), wdt)
            sent = sum(_nbytes(region(p), wdt)
                       for p in group if S.dev(p) != dev)
            res.append(torch.empty(shp, dtype=dt, device=dev))
            _cost.record_collective("reduce-scatter", dev, sent, recv,
                                    what, shp, dt)
            continue
        sl = _slices(region(q))
        acc = None
        with _cost.collective("reduce-scatter"):
            for p in group:
                g = by[p][sl].to(dev, _acc(by[p].dtype))
                acc = g if acc is None else acc + g
        res.append(acc.to(dt))
    return res


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *parts):
        ctx.op = op
        ctx.metas = [(t.dtype, tuple(t.shape), t.device) for t in parts]
        return tuple(op.forward(parts))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.op.backward(grads, ctx.metas))


def all_gather(S: Spmd, parts: dict, axes, region: Callable,
               shape: Callable, *, dtype=None, readers=None,
               what: str = "") -> dict:
    """{p: the assembled tensor} for each position ``p`` of ``S.run``:
    ``shape(p)`` in ``dtype`` (the part's when None), each peer q of p
    over ``axes`` writing its part ``parts[q]`` at ``region(q)``. The
    gradient of ``parts[q]`` sums the gradients at ``region(q)`` of q's
    peers over ``readers`` (``axes`` when None)."""
    op = _GatherOp(S, tuple(axes), tuple(axes if readers is None
                                         else readers),
                   region, shape, dtype, what)
    outs = _Gather.apply(op, *[parts[p] for p in S.run])
    return dict(zip(S.run, outs))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *parts):
        ctx.op = op
        ctx.metas = [(t.dtype, tuple(t.shape), t.device) for t in parts]
        S, out = op.S, []
        for p in S.run:
            dev = S.dev(p)
            shp = tuple(hi - lo for lo, hi in op.region(p))
            out.append((op.dtype, shp, dev))
        return tuple(_scatter_sum(S, parts, op.axes, op.region,
                                  [t.dtype for t in parts], out, op.what))

    @staticmethod
    def backward(ctx, *grads):
        op = ctx.op
        shapes = {p: shp for p, (_, shp, _) in zip(op.S.run, ctx.metas)}
        back = _GatherOp(op.S, op.axes, op.axes, op.region, shapes.get,
                         None, op.what)
        parts = back.forward([g.to(dt) for g, (dt, _, _)
                              in zip(grads, ctx.metas)])
        return (None,) + tuple(parts)


def reduce_scatter(S: Spmd, parts: dict, axes, region: Callable, *,
                   dtype, what: str = "", op: str = "sum",
                   counts: dict | None = None) -> dict:
    """{p: the sum (``op="max"``: the maximum) of p's peers' parts over
    ``axes`` at p's own region ``region(p)``} for each position of
    ``S.run``: in row-major order, in float32, cast once to ``dtype``.
    The parts share one shape. The sum's backward is the all-gather,
    each part's gradient its peers' output gradients each at its region.
    The maximum differentiates only with ``counts`` ({p: the counts of
    p's local ties, the parts' shape}): see the module docstring."""
    if op == "max":
        red = _MaxOp(S, tuple(axes), region, dtype, what)
        ins = [parts[p] for p in S.run]
        if counts is not None:
            ins += [counts[p] for p in S.run]
        outs = _ReduceMax.apply(red, counts is not None, *ins)
        return dict(zip(S.run, outs))
    if op != "sum":
        raise ValueError(f"reduce_scatter op {op!r}: sum or max")
    # the all-gather whose backward this forward is (its shape unused)
    red = _GatherOp(S, tuple(axes), tuple(axes), region, None, dtype, what)
    outs = _ReduceScatter.apply(red, *[parts[p] for p in S.run])
    return dict(zip(S.run, outs))


def _near(S: Spmd, p, q) -> bool:
    """True when q's data reaches p by a copy the walk sees: on real
    tensors always (between devices a copy named for its collective), on
    fakes when q shares p's device (between devices a fake moves nothing
    and its bytes are booked)."""
    return not S.fake or S.dev(q) == S.dev(p)


def _book(kind, S, p, axes, region, dtype, what, shape):
    """On fakes, p's bytes of a ``kind`` over its peers on other devices:
    an all-gather receives their regions and sends its own to each; a
    reduce-scatter sends them their regions and receives its own from
    each."""
    far = [q for q in peers(S.mesh, p, axes) if not _near(S, p, q)]
    if not far:
        return
    theirs = sum(_nbytes(region(q), dtype) for q in far)
    mine = len(far) * _nbytes(region(p), dtype)
    sent, recv = (mine, theirs) if kind == "all-gather" else (theirs, mine)
    _cost.record_collective(kind, S.dev(p), sent, recv, what, shape, dtype)


@dataclasses.dataclass(frozen=True)
class _MaxOp:
    S: Spmd
    axes: tuple
    region: Callable
    dtype: Any
    what: str


class _ReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, tied, *tensors):
        S = op.S
        k = len(S.run)
        by = dict(zip(S.run, tensors[:k]))
        cby = dict(zip(S.run, tensors[k:])) if tied else None
        ctx.op, ctx.tied = op, tied
        ctx.metas = [(t.dtype, tuple(t.shape), t.device)
                     for t in tensors[:k]]
        ctx.near, ctx.masks, ctx.ties = {}, {}, {}
        outs = []
        for q in S.run:
            dev, sl = S.dev(q), _slices(op.region(q))
            shp = tuple(hi - lo for lo, hi in op.region(q))
            near = [p for p in peers(S.mesh, q, op.axes) if _near(S, q, p)]
            _book("reduce-scatter", S, q, op.axes, op.region,
                  by[q].dtype, op.what, shp)
            with _cost.collective("reduce-scatter"):
                xs = [by[p][sl].to(dev, _acc(by[p].dtype)) for p in near]
            top = xs[0]
            for x in xs[1:]:
                top = torch.maximum(top, x)
            if tied:
                _book("reduce-scatter", S, q, op.axes, op.region,
                      cby[q].dtype, op.what + "/ties", shp)
                masks = [x == top for x in xs]
                tot = None
                with _cost.collective("reduce-scatter"):
                    for p, m in zip(near, masks):
                        c = torch.where(m, cby[p][sl].to(dev, top.dtype),
                                        0.0)
                        tot = c if tot is None else tot + c
                ctx.near[q], ctx.masks[q] = near, masks
                ctx.ties[q] = torch.clamp(tot, min=1.0)
            outs.append(top.to(op.dtype))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        if not ctx.tied:
            raise RuntimeError("a max reduce-scatter differentiates only "
                               "with counts of its ties")
        op = ctx.op
        S = op.S
        # each output entry's share g / K, at the member that holds it
        share = {q: g.to(ctx.ties[q].dtype) / ctx.ties[q]
                 for q, g in zip(S.run, grads)}
        out = {p: torch.empty(shp, dtype=dt, device=dev)
               for p, (dt, shp, dev) in zip(S.run, ctx.metas)}
        for q in S.run:
            with _cost.collective("all-gather"):
                for p, m in zip(ctx.near[q], ctx.masks[q]):
                    out[p][_slices(op.region(q))] = torch.where(
                        m, share[q], 0.0).to(out[p].device, out[p].dtype)
        for p, (dt, shp, _) in zip(S.run, ctx.metas):
            _book("all-gather", S, p, op.axes, op.region, dt, op.what, shp)
        return (None, None) + tuple(out[p] for p in S.run) \
            + (None,) * len(S.run)


@dataclasses.dataclass(frozen=True)
class _AtOp:
    S: Spmd
    p: tuple
    axes: tuple
    region: Callable
    shape: tuple
    dtype: Any
    what: str


class _GatherAt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *parts):
        S, p = op.S, op.p
        by = dict(zip(S.run, parts))
        ctx.op = op
        ctx.metas = [(t.dtype, tuple(t.shape), t.device) for t in parts]
        dt = op.dtype or by[p].dtype
        out = torch.empty(op.shape, dtype=dt, device=S.dev(p))
        _book("all-gather", S, p, op.axes, op.region, dt, op.what,
              out.shape)
        with _cost.collective("all-gather"):
            for q in peers(S.mesh, p, op.axes):
                if _near(S, p, q):
                    out[_slices(op.region(q))] = by[q]
        return out

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        S, p = op.S, op.p
        near = {q for q in peers(S.mesh, p, op.axes) if _near(S, p, q)}
        _book("reduce-scatter", S, p, op.axes, op.region, g.dtype, op.what,
              tuple(hi - lo for lo, hi in op.region(p)))
        grads = []
        with _cost.collective("reduce-scatter"):
            for q, (dt, _, dev) in zip(S.run, ctx.metas):
                # a copy, not a view: the whole gradient is freed here
                grads.append(g[_slices(op.region(q))].to(dev, dt, copy=True)
                             if q in near else None)
        return (None,) + tuple(grads)


def gather_at(S: Spmd, parts: dict, p, axes, region: Callable,
              shape: tuple, *, dtype=None, what: str = "") -> torch.Tensor:
    """Position p's all-gather: ``shape`` in ``dtype`` (p's part's when
    None) on p's device, each peer q of p over ``axes`` writing its part
    ``parts[q]`` at ``region(q)``. The backward gives each peer the
    gradient at its region (a reduce-scatter, as autograd adds up the
    gathers of every position)."""
    op = _AtOp(S, p, tuple(axes), region, tuple(shape), dtype, what)
    return _GatherAt.apply(op, *[parts[q] for q in S.run])


@dataclasses.dataclass(frozen=True)
class _IntoOp:
    S: Spmd
    axes: tuple
    region: Callable
    what: str


class _ScatterInto(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, p, near, part, *sums):
        S = op.S
        ctx.op, ctx.p, ctx.near = op, p, near
        ctx.meta = (part.dtype, tuple(part.shape), part.device)
        _book("reduce-scatter", S, p, op.axes, op.region, part.dtype,
              op.what, tuple(hi - lo for lo, hi in op.region(p)))
        ctx.fresh = tuple(acc is None for acc in sums)
        out = []
        with _cost.collective("reduce-scatter"):
            for q, acc in zip(near, sums):
                x = part[_slices(op.region(q))]
                if acc is None:
                    acc = x.to(S.dev(q), _acc(x.dtype), copy=True)
                else:
                    acc.add_(x.to(S.dev(q), acc.dtype))
                out.append(acc)
        ctx.mark_dirty(*[acc for acc in sums if acc is not None])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        op, p = ctx.op, ctx.p
        dt, shp, dev = ctx.meta
        g = torch.empty(shp, dtype=dt, device=dev)
        with _cost.collective("all-gather"):
            for q, gq in zip(ctx.near, grads):
                g[_slices(op.region(q))] = gq
        _book("all-gather", op.S, p, op.axes, op.region, dt, op.what, shp)
        return (None, None, None, g) + tuple(
            None if fresh else gq for fresh, gq in zip(ctx.fresh, grads))


class ScatterSum:
    """A reduce-scatter fed one position at a time: :meth:`add` each
    position's part (all of one shape and dtype) in row-major order, then
    :meth:`result` gives {q: the sum of q's peers' parts over ``axes`` at
    ``region(q)``} in the parts' dtype for each position of ``S.run``,
    summed in float32 in the order the parts came, cast once. A part is
    added into its peers' sums when it comes and is not kept; the
    backward gives each part its peers' output gradients at their
    regions."""

    def __init__(self, S: Spmd, axes, region: Callable, *, what: str = ""):
        self.op = _IntoOp(S, tuple(axes), region, what)
        self.dtype = None
        self.sums: dict = {}

    def add(self, p, part: torch.Tensor) -> None:
        self.dtype = part.dtype
        S = self.op.S
        near = tuple(q for q in peers(S.mesh, p, self.op.axes)
                     if _near(S, p, q))
        outs = _ScatterInto.apply(self.op, p, near, part,
                                  *[self.sums.get(q) for q in near])
        self.sums.update(zip(near, outs))

    def result(self) -> dict:
        return {q: self.sums.pop(q).to(self.dtype) for q in self.op.S.run}


def _cut(n: int, k: int, i: int) -> tuple[int, int]:
    """Chunk i of k of n elements (the first n % k one longer)."""
    q, r = divmod(n, k)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


@dataclasses.dataclass(frozen=True)
class _ReduceOp:
    S: Spmd
    axes: tuple
    what: str
    op: str = "sum"

    def reduce(self, parts, dtypes):
        """A ring-style all-reduce of each group: its parts, flattened,
        cut into one chunk a member; member i reduces chunk i over the
        group in row-major order (in float32), casts it once, and every
        member gathers the reduced chunks."""
        S, mesh = self.S, self.S.mesh
        by = dict(zip(S.run, parts))
        outs = []
        red = {}
        for p, dt in zip(S.run, dtypes):
            dev, t = S.dev(p), by[p]
            group = peers(mesh, p, self.axes)
            k, n = len(group), t.numel()
            if S.fake:
                i = group.index(p)
                mine = _cut(n, k, i)[1] - _cut(n, k, i)[0]
                sent = recv = 0
                for j, q in enumerate(group):
                    if S.dev(q) == dev:
                        continue
                    c = _cut(n, k, j)
                    theirs = c[1] - c[0]
                    recv += mine * t.element_size() + theirs * dt.itemsize
                    sent += theirs * t.element_size() + mine * dt.itemsize
                outs.append(torch.empty(t.shape, dtype=dt, device=dev))
                _cost.record_collective("all-reduce", dev, sent, recv,
                                        self.what, t.shape, dt)
                continue
            with _cost.collective("all-reduce"):
                chunks = []
                for j, q in enumerate(group):
                    key = (q, self.op, dt)
                    if key not in red:
                        lo, hi = _cut(n, k, j)
                        acc = None
                        for r in group:
                            x = by[r].reshape(-1)[lo:hi].to(
                                S.dev(q), _acc(by[r].dtype))
                            acc = x if acc is None else (
                                acc + x if self.op == "sum"
                                else torch.maximum(acc, x))
                        red[key] = acc.to(dt)
                    chunks.append(red[key].to(dev))
                outs.append(torch.cat(chunks).view(t.shape))
        return outs


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, dtype, *parts):
        ctx.op = op
        ctx.dtypes = [t.dtype for t in parts]
        return tuple(op.reduce(parts, [dtype or t.dtype for t in parts]))

    @staticmethod
    def backward(ctx, *grads):
        if ctx.op.op != "sum":
            raise RuntimeError("only a summing all-reduce differentiates")
        return (None, None) + tuple(ctx.op.reduce(grads, ctx.dtypes))


def all_reduce(S: Spmd, parts: dict, axes, *, dtype=None,
               what: str = "", op: str = "sum") -> dict:
    """{p: the sum of the parts of p's peers over ``axes``} for each
    position of ``S.run``, in row-major order, in float32, cast once to
    ``dtype`` (the part's when None)."""
    red = _ReduceOp(S, tuple(axes), what, op)
    outs = _AllReduce.apply(red, dtype, *[parts[p] for p in S.run])
    return dict(zip(S.run, outs))
