"""The op walk: what one call of a step costs on each device of its mesh
(port of ``repro/launch/hlo_walk.py``; the file keeps the reference's
name so the two module trees stay in step).

The reference walks compiled HLO text, because XLA's cost analysis
counts a loop body once. The port has no HLO and nothing is compiled:
it walks the aten ops that eager PyTorch dispatches when the step runs,
as a ``TorchDispatchMode``, normally inside ``FakeTensorMode`` so that
no tensor holds data (``launch/dryrun.py``). Eager dispatch visits every
iteration of every loop, so nothing needs a trip count, and it does not
fuse, so each op that does work is a kernel. Per device it counts:

  * FLOPs of the matmul family only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``_scaled_dot_product_*``), through
    ``torch.utils.flop_counter``'s registry, and their time at the
    card's rate for the product's dtype (``kernels/cost.py``: bf16 and
    fp16 on the tensor cores, float32 outside them unless TF32 is
    allowed). The reference's walk counts dot FLOPs and adds one FLOP a
    result element of every other op; the port counts no elementwise
    FLOPs;
  * HBM bytes: operand and result bytes of every op that does work.
    Views and shape-only ops are skipped, as the reference skips tuple,
    get-tuple-element, bitcast and parameter; an allocation moves no
    bytes. A gather (``index_select``, ``embedding``, indexing) moves
    its indices and the rows it reads, not its whole table: the
    result's bytes twice; a scatter (``index_add``, ``index_put``,
    ``scatter*``) its indices and its values three times (read, and the
    rows they land on read and written), plus a copy of the destination
    when it is not in place;
  * collective bytes: every copy between two distinct devices, sent by
    one and received by the other, under the kind that the code around
    it names with ``kernels/cost.collective`` ("copy" where none is
    named; "host" where one side is the CPU);
  * the peak of live storage: each storage counted once from the op
    that made it until the last tensor on it is freed, the arguments
    from the start.

A hand-written kernel launches through ``ctypes``, which no dispatch
mode sees: on fake tensors its wrapper records one op at its cost
function's bytes and operations (``kernels/cost.py``), counted here
under the kernel's name, with the shape of the largest tensor it writes
(its result or its scratch).

Each record keeps the element counts of the arrays its op writes
(``OpRecord.outs``) and of the scratch arrays a library op allocates
for itself (``OpRecord.scratch``, :func:`library_scratch`), which the
analyzer's frontier count reads (``analysis/jaxpr_passes.
count_hbm_intermediates``); neither moves the totals.

The totals are the busiest device's: each of FLOPs, compute time, HBM
bytes and collective bytes (the larger of sent and received) is the
largest any device of the mesh has, since a step takes as long as its
slowest device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import cost as _cost

# the matmul family, whose FLOPs the walk counts
MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_flash_attention",
              "_scaled_dot_product_cudnn_attention",
              "_scaled_dot_product_efficient_attention_backward",
              "_scaled_dot_product_flash_attention_backward",
              "_scaled_dot_product_cudnn_attention_backward")
# ops that allocate and move no bytes, and ops that only read metadata
_NO_WORK = {"empty", "empty_strided", "new_empty", "new_empty_strided",
            "empty_like", "detach", "alias", "lift_fresh", "_unsafe_view",
            "_reshape_alias", "set_", "resize_", "is_same_size",
            "_has_compatible_shallow_copy_type", "sym_size", "sym_stride",
            "sym_numel", "sym_storage_offset", "_local_scalar_dense",
            "record_stream"}

# torch's CUDA sort sorts a dimension of at most this many in place; a
# longer one goes through a radix sort that allocates scratch
SORT_INPLACE_MAX = 4096
# row gathers and scatters, whose tables are not read whole
_GATHERS = {"index_select", "embedding", "gather", "index", "take"}
_SCATTERS = {"index_add", "index_put", "scatter", "scatter_add",
             "scatter_reduce", "index_copy", "_index_put_impl"}

@dataclasses.dataclass
class DeviceCost:
    """One device's share of a step."""
    flops: float = 0.0
    compute_s: float = 0.0
    hbm_bytes: float = 0.0
    coll_sent: float = 0.0
    coll_recv: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    live_bytes: float = 0.0
    peak_bytes: float = 0.0
    arg_bytes: float = 0.0
    out_bytes: float = 0.0
    ops: int = 0

    @property
    def coll_bytes(self) -> float:
        return max(self.coll_sent, self.coll_recv)


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op that did work: its name ("kernel:<name>" for a port
    kernel, whose bytes are its cost's), device, its largest result's
    dtype, shape and bytes, for a copy between devices its collective
    kind, and the element count of each array it writes."""
    op: str
    device: str
    dtype: str
    shape: tuple
    nbytes: int
    kind: str | None = None
    outs: tuple = ()
    scratch: tuple = ()


@dataclasses.dataclass
class WalkTotals:
    """The busiest device's FLOPs, HBM bytes, collective bytes and
    collective bytes by kind (the reference's four fields), then the
    port's: compute seconds at each op's rate, peak live bytes,
    argument, output and alias bytes, every device's
    :class:`DeviceCost`, the port kernels' calls by name, and the
    records of the ops."""
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_op: dict
    compute_s: float = 0.0
    peak_bytes: float = 0.0
    arg_bytes: float = 0.0
    out_bytes: float = 0.0
    alias_bytes: float = 0.0
    devices: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    records: list = dataclasses.field(default_factory=list)
    n_ops: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def leaf_tensors(tree) -> list:
    """The tensors of a pytree, a module's parameters and buffers, an
    AdamW state or a :class:`~repro_torch.launch.sharding.ShardedTensor`
    (its pieces), depth first."""
    from repro_torch.launch.sharding import ShardedTensor
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, ShardedTensor):
            stack.extend(x.pieces.values())
        elif isinstance(x, torch.nn.Module):
            stack.extend(x.parameters())
            stack.extend(x.buffers())
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return out


def _op_bytes(name: str, ins: list, outs: list) -> int:
    """HBM bytes of one op (see the module docstring)."""
    base = name.rstrip("_")
    if base in _GATHERS or base in _SCATTERS:
        rest = ins[1:]
        idx = sum(_nbytes(t) for t in rest if not t.is_floating_point())
        if base in _GATHERS:
            return idx + 2 * sum(map(_nbytes, outs))
        vals = sum(_nbytes(t) for t in rest if t.is_floating_point())
        copy = 0 if name.endswith("_") else 2 * _nbytes(ins[0])
        return idx + 3 * vals + copy
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


def library_scratch(name: str, args, kwargs) -> tuple:
    """Element counts of the scratch arrays that a library op allocates
    for itself, at most: ``sort`` along a dimension longer than
    ``SORT_INPLACE_MAX`` -- a copy of the keys, two int64 index buffers
    and the radix sort's temporary storage, each taken at the input's
    size (on an H100 with torch 2.11 all four were at least half the
    input's size at (16, 10,000), and none was at (8, 10^6)). Empty for
    any other op."""
    if name != "sort" or not args or not args[0].dim():
        return ()
    x = args[0]
    dim = args[1] if len(args) > 1 and isinstance(args[1], int) \
        else kwargs.get("dim", -1)
    return (x.numel(),) * 4 if x.shape[dim] > SORT_INPLACE_MAX else ()


def _storage(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


class OpWalk(TorchDispatchMode):
    """The dispatch mode that counts; :func:`analyze` drives it."""

    def __init__(self):
        super().__init__()
        self.dev: dict[str, DeviceCost] = defaultdict(DeviceCost)
        self.records: list[OpRecord] = []
        self.kernels: Counter = Counter()
        self._live: dict = {}          # storage -> [bytes, device, refs]
        self._args: set = set()
        self._rates = {torch.bfloat16: _cost.BF16_OPS_PER_S,
                       torch.float16: _cost.BF16_OPS_PER_S}
        self._f32 = (_cost.TF32_OPS_PER_S
                     if torch.backends.cuda.matmul.allow_tf32
                     else _cost.FP32_OPS_PER_S)
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = {p: fn for p, fn in flop_registry.items()
                          if getattr(p, "__name__", "").split(".")[0]
                          in MATMUL_OPS}

    # ---- storage ------------------------------------------------------
    def track(self, t: torch.Tensor, arg: bool = False) -> None:
        key, nb = _storage(t)
        d = str(t.device)
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [nb, d, 0]
            dc = self.dev[d]
            dc.live_bytes += nb
            dc.peak_bytes = max(dc.peak_bytes, dc.live_bytes)
            if arg:
                dc.arg_bytes += nb
                self._args.add(key)
        ent[2] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[2] -= 1
        if ent[2] == 0:
            del self._live[key]
            self.dev[ent[1]].live_bytes -= ent[0]

    # ---- ops ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        if func.namespace == "aten" and name not in _NO_WORK:
            # a composite op (matmul under inference_mode, say) reaches
            # the mode whole: walk the ops it is made of instead
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if name in _NO_WORK or func.namespace == "prim" or \
                getattr(func, "is_view", False):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if not ins and not outs:
            return out
        if name in ("_to_copy", "copy_"):
            src, dst = (ins[0], outs[0]) if name == "_to_copy" else \
                (ins[1], ins[0])
            if src.device != dst.device:
                self._copy(src, dst)
                return out
        big = max(outs, key=_nbytes, default=None)
        dev = str(big.device if big is not None else ins[0].device)
        dc = self.dev[dev]
        flops = 0.0
        fn = self._flop_fns.get(func.overloadpacket)
        if fn is not None:
            flops = float(fn(*args, **kwargs, out_val=out))
            rate = self._rates.get(ins[0].dtype, self._f32)
            dc.flops += flops
            dc.compute_s += flops / rate
        dc.hbm_bytes += _op_bytes(name, ins, outs)
        dc.ops += 1
        self._record(name, dev, big, outs=outs,
                     scratch=library_scratch(name, args, kwargs))
        return out

    def _copy(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        nb = _nbytes(src)
        s, d = str(src.device), str(dst.device)
        kind = "host" if "cpu" in (src.device.type, dst.device.type) \
            else (_cost.collective_kind() or "copy")
        self.dev[s].coll_sent += nb
        self.dev[s].hbm_bytes += nb
        recv = self.dev[d]
        recv.coll_recv += nb
        recv.hbm_bytes += nb
        recv.coll_by_op[kind] = recv.coll_by_op.get(kind, 0.0) + nb
        recv.ops += 1
        self._record("copy", d, dst, kind, outs=(dst,))

    def _record(self, name, dev, t, kind=None, outs=(),
                scratch=()) -> None:
        self.records.append(OpRecord(
            name, dev, str(t.dtype).replace("torch.", "") if t is not None
            else "", tuple(t.shape) if t is not None else (),
            _nbytes(t) if t is not None else 0, kind,
            tuple(o.numel() for o in outs), scratch))

    def kernel(self, name: str, kc: _cost.KernelCost, device,
               out=()) -> None:
        """A port kernel's call on fake tensors: one op at its cost, with
        the dtype and shape of the largest tensor of ``out`` that it
        writes."""
        d = str(device)
        dc = self.dev[d]
        dc.flops += kc.flops
        dc.compute_s += kc.ops / kc.rate
        dc.hbm_bytes += kc.bytes
        dc.ops += 1
        self.kernels[name] += 1
        big = max(out, key=_nbytes, default=None)
        self.records.append(OpRecord(
            "kernel:" + name, d,
            "" if big is None else str(big.dtype).replace("torch.", ""),
            () if big is None else tuple(big.shape), int(kc.bytes),
            outs=tuple(o.numel() for o in out)))

    # ---- totals -------------------------------------------------------
    def totals(self, out=None) -> WalkTotals:
        alias = 0.0
        seen = set()
        for t in leaf_tensors(out):
            key, nb = _storage(t)
            if key in seen:
                continue
            seen.add(key)
            self.dev[str(t.device)].out_bytes += nb
            if key in self._args:
                alias += nb
        devs = dict(self.dev)
        busiest = (lambda f: max((f(c) for c in devs.values()), default=0.0))
        kinds = sorted({k for c in devs.values() for k in c.coll_by_op})
        return WalkTotals(
            flops=busiest(lambda c: c.flops),
            hbm_bytes=busiest(lambda c: c.hbm_bytes),
            coll_bytes=busiest(lambda c: c.coll_bytes),
            coll_by_op={k: busiest(lambda c: c.coll_by_op.get(k, 0.0))
                        for k in kinds},
            compute_s=busiest(lambda c: c.compute_s),
            peak_bytes=busiest(lambda c: c.peak_bytes),
            arg_bytes=busiest(lambda c: c.arg_bytes),
            out_bytes=busiest(lambda c: c.out_bytes),
            alias_bytes=alias, devices=devs, kernels=dict(self.kernels),
            records=self.records,
            n_ops=sum(c.ops for c in devs.values()))


def _fake_mode(args):
    from torch._guards import detect_fake_mode
    return detect_fake_mode([t for t in leaf_tensors(args)])


def analyze(fn, *args, **kwargs) -> WalkTotals:
    """Call ``fn(*args, **kwargs)`` once under the walk and return its
    totals. Fake arguments run under their ``FakeTensorMode`` (entered
    here when it is not active); the arguments' storages count from the
    start, the result's as output bytes."""
    walk = OpWalk()
    mode = _fake_mode((args, kwargs))
    from torch._guards import active_fake_mode
    with contextlib.ExitStack() as stack:
        if mode is not None and active_fake_mode() is not mode:
            stack.enter_context(mode)
        for t in leaf_tensors((args, kwargs)):
            walk.track(t, arg=True)
        stack.enter_context(_cost.listen(walk.kernel, outputs=True))
        with walk:
            out = fn(*args, **kwargs)
        totals = walk.totals(out)
        del out
    return totals
