"""What each hand-written kernel costs, and the seam through which a
kernel called on fake tensors is counted instead of launched.

A kernel's cost is the work its function needs, counted from the
shapes (and, where the work depends on the data, from what the data
needs): ``bytes``, each input read once and each output written once,
and ``flops``, the arithmetic the function does, run ``passes`` times at
``rate`` operations a second (``cin``'s 3xTF32 does every multiply-add
three times on the tensor cores). Each kernel module keeps the cost
function of its wrappers beside them; ``chip_smoke.py`` phase 4 and the
op walk (``launch/hlo_walk.py``) read the same functions, so a bound and
a roofline count the same work whatever implements the kernel.

The rates are one NVIDIA H100 SXM's published peaks (NVIDIA's data
sheet, dense, at its 700 W power limit); TF32 is the data sheet's 494.7
TFLOP/s, which the sheet's summary rounds to 495.

A wrapper given ``FakeTensor`` inputs (``torch._subclasses.fake_tensor``,
the dry run's stand-ins: shapes and devices, no data) neither launches
nor runs the plain version: it makes empty outputs of the kernel's
shapes and calls :func:`record`, which hands the cost to every listener
that :func:`listen` installed (the op walk). Where the cost depends on
data a fake does not hold, the wrapper takes the static worst case and
names it with :func:`worst_case`. Real tensors never reach this path.

Code that moves data between the devices of a mesh names what the move
is (say "all-gather") with :func:`collective`, which the op walk reads
through :func:`collective_kind`; the name changes nothing else.

A fake branch that skips a read of data to the host (an ``int(t)``, a
``.cpu()``) which the real branch makes names that read with
:func:`host_read`, so that a recorder of host syncs
(``analysis/jaxpr_passes.py``, listening through :func:`listen_syncs`)
sees on fakes the sync that real tensors make.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensor

HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
TF32_OPS_PER_S = 494.7e12      # dense TF32 tensor cores
BF16_OPS_PER_S = 989e12        # dense bf16 / fp16 tensor cores
NVLINK_BYTES_PER_S = 450e9     # NVLink 4, each way

_lock = threading.Lock()
_listeners: list = []         # (fn, whether fn takes the outputs)
_sync_listeners: list = []
_worst: list = []
_local = threading.local()    # this thread's stack of collective kinds


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """The work of one kernel call: ``bytes`` moved through device
    memory, ``flops`` of arithmetic, each done ``passes`` times at
    ``rate`` operations a second."""
    bytes: float
    flops: float
    rate: float = FP32_OPS_PER_S
    passes: int = 1

    @property
    def ops(self) -> float:
        return self.flops * self.passes

    def __add__(self, other: "KernelCost") -> "KernelCost":
        """Two calls of one kernel (the same rate and passes) as one."""
        if (self.rate, self.passes) != (other.rate, other.passes):
            raise ValueError("costs at different rates do not add up")
        return dataclasses.replace(self, bytes=self.bytes + other.bytes,
                                   flops=self.flops + other.flops)

    def bound_ms(self) -> tuple[float, str]:
        """The least time the card could take, in ms, and what bounds it:
        the larger of the bytes over the memory rate and the operations
        over ``rate``."""
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.ops / self.rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")


def total(costs) -> KernelCost:
    """Several calls of one kernel as one cost."""
    costs = list(costs)
    out = costs[0]
    for c in costs[1:]:
        out = out + c
    return out


def is_fake(*tensors) -> bool:
    """True when any of ``tensors`` is a ``FakeTensor`` (the dry run's)."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def faking() -> bool:
    """True inside an active ``FakeTensorMode`` (where new tensors are
    fake): a cache of device buffers must not keep one."""
    return active_fake_mode() is not None


@contextlib.contextmanager
def collective(kind: str):
    """Name the copies between devices that this thread makes inside the
    block (say "all-gather"), for the op walk's ``coll_by_op``; nothing
    else changes."""
    stack = _local.__dict__.setdefault("kinds", [])
    stack.append(kind)
    try:
        yield
    finally:
        stack.pop()


def collective_kind() -> str | None:
    """The kind that this thread's innermost :func:`collective` block
    names, None outside one."""
    stack = getattr(_local, "kinds", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def listen(fn, outputs: bool = False):
    """Inside the block, :func:`record` calls ``fn(name, cost, device)``,
    and ``fn(name, cost, device, out)`` under ``outputs``."""
    ent = (fn, outputs)
    with _lock:
        _listeners.append(ent)
    try:
        yield
    finally:
        with _lock:
            _listeners.remove(ent)


def record(name: str, cost: KernelCost, device, out=()) -> None:
    """One call of kernel ``name`` on fake tensors: its cost, and the
    tensors ``out`` that the kernel writes (its results and its scratch),
    to every listener."""
    for fn, outputs in list(_listeners):
        if outputs:
            fn(name, cost, device, tuple(out))
        else:
            fn(name, cost, device)


@contextlib.contextmanager
def listen_syncs(fn):
    """Inside the block, :func:`host_read` calls ``fn(op)``."""
    with _lock:
        _sync_listeners.append(fn)
    try:
        yield
    finally:
        with _lock:
            _sync_listeners.remove(fn)


def host_read(op: str) -> None:
    """A fake branch stands in for a read to the host that real tensors
    make there: ``op`` is the aten op of that read (``"_local_scalar_dense"``
    for an ``int(t)``, ``"_to_copy"`` for a ``.cpu()``), told to every
    sync listener; nothing else changes."""
    for fn in list(_sync_listeners):
        fn(op)


def worst_case(what: str) -> None:
    """Name a static worst case taken for data a fake tensor does not
    hold (kept once; :func:`worst_cases` reads them)."""
    with _lock:
        if what not in _worst:
            _worst.append(what)


def worst_cases(clear: bool = False) -> list[str]:
    """The worst cases named since the last clear."""
    with _lock:
        out = list(_worst)
        if clear:
            _worst.clear()
    return out
