"""Declared program universe for the dispatch and collective passes.

Port of ``repro/analysis/programs.py``. One registry of every program
the serving stack dispatches into -- pair / single-source / top-k on
both push backends, the sharded fan-out twins, the join tile program,
the paired-walk sampler and the prsim builder's PageRank step -- each
with the *declared* bucket class of every shape dimension the engine
may vary at runtime. The jit-boundary pass runs each spec once and
re-derives the bucket predicates from the live ``EngineConfig`` /
``JoinConfig`` defaults, so a dimension that silently stops being
bucketed becomes a static finding.

The reference traces jitted functions on ``ShapeDtypeStruct``s. The
port has no jit: a spec's ``make(devices)`` builds real arguments from
a seeded graph and packed table at the reference's geometry
(:func:`_geometry`), on the devices named, and returns the program as a
callable over them. Each program stops where the reference's jit
returns, at device tensors: arguments are placed before the call and
nothing is read back after it. By default

  * a plain program (``backend="plain"``, the reference's ``lax``) runs
    on real CPU tensors;
  * a kernel program (``"kernel"``, the reference's ``pallas``) runs on
    fake tensors on a ``meta`` device under ``FakeTensorMode``, as the
    dry run does (``launch/dryrun.py``): the kernel wrappers make their
    outputs empty and record one op at their cost;
  * a sharded program runs on a mesh of two distinct fake devices,
    ``meta:0`` and ``meta:1``, on either backend: the reference's
    2-device mesh. The CPU offers no second real device (a mesh of
    ``["cpu"] * 2`` is one device, whose fan-out makes no copies), and
    a fake one needs no card. ``["cuda:0"] * 2`` on one card takes the
    fan-out's one-device route (``core/shard_query.py``).

``make`` takes other devices (``["cuda"]`` on the card), where the
same seed gives the same data.

Dimensions the reference buckets through a compile control that the
port leaves out by design are kept only where the port's program has
that dimension: ``walk-chunk`` (the port's walk runs each chunk at its
own size) and ``eb-multiple`` (the Pallas blocked edge layout, whose
port is an exact CSR) are gone, and so are the flat edge buckets of
programs whose CSR takes its exact size.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

SEED = 0
N_SHARDS = 2

# bucket classes the reference declares whose compile control the port
# leaves out by design (ROADMAP "Not ported, by design")
LEFT_OUT_BUCKETS = ("walk-chunk", "eb-multiple")


@dataclasses.dataclass(frozen=True)
class Dim:
    """One shape dimension of a program and its declared bucket class."""
    name: str
    value: int
    bucket: str


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    name: str                    # e.g. "source/kernel"
    file: str                    # repo-relative defining module
    make: Callable               # (devices=None) -> (fn, args)
    dims: tuple[Dim, ...]
    devices: int = 1             # mesh positions the program runs on
    backend: str | None = None   # "plain" | "kernel" | None (neither)


def universe() -> dict:
    """The engine's declared shape-bucket universe (one source of truth
    for every bucket predicate)."""
    from repro_torch.join.sweep import JoinConfig
    from repro_torch.serve.engine import EngineConfig
    ec, jc = EngineConfig(), JoinConfig()
    return {
        "cap_quantum": ec.cap_quantum,
        "pair_batch": ec.pair_batch,
        "source_batch": ec.source_batch,
        "k_buckets": tuple(ec.k_buckets),
        "join_tile": jc.tile,
    }


def bucket_ok(dim: Dim, n: int, uni: dict) -> bool:
    """Is ``dim.value`` inside the declared universe for its class?"""
    v = dim.value
    if dim.bucket == "cap-bucket":
        q = uni["cap_quantum"]
        return v >= q and v % q == 0
    if dim.bucket == "k-bucket":
        ks = {b for b in uni["k_buckets"] if b <= n} | {n}
        return v in ks
    if dim.bucket == "engine-pair-batch":
        return v == uni["pair_batch"]
    if dim.bucket == "engine-source-batch":
        return v == uni["source_batch"]
    if dim.bucket == "join-tile":
        return v == uni["join_tile"]
    if dim.bucket in LEFT_OUT_BUCKETS:
        raise ValueError(f"bucket class {dim.bucket!r} names a compile "
                         "control the port leaves out by design")
    raise ValueError(f"unknown bucket class {dim.bucket!r}")


# ----------------------------------------------------------------------
# the seeded inputs (the reference's tiny representative geometry)
# ----------------------------------------------------------------------
def _geometry(uni: dict) -> dict:
    from repro_torch.core.hp_index import capacity_bucket
    n, deg = 256, 3
    m = deg * n
    return {"n": n, "deg": deg, "m": m, "l_max": 10, "W": 64,
            "E": capacity_bucket(m, uni["cap_quantum"])}


def host_inputs(n: int, deg: int, W: int, l_max: int,
                seed: int = SEED) -> dict:
    """NumPy inputs of every program, from ``seed``: a graph whose every
    node has ``deg`` distinct in-neighbours other than itself, a packed
    table (n, W) -- each row's keys l*n + k ascending, at most W of them
    and at least one, PAD last, values in (0.01, 0.5) --, d in [0.4, 1),
    the Horner threshold, and a generator for query ids."""
    from repro_torch.core.hp_index import INT32_PAD_KEY
    rng = np.random.default_rng(seed)
    off = rng.integers(1, n, (n, deg))
    for _ in range(64):            # redraw the rows that repeat an offset
        srt = np.sort(off, axis=1)
        bad = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not bad.any():
            break
        off[bad] = rng.integers(1, n, (int(bad.sum()), deg))
    src = ((np.arange(n)[:, None] + off) % n).ravel()
    dst = np.repeat(np.arange(n), deg)
    keys = np.sort(rng.integers(0, (l_max + 1) * n, (n, W)), axis=1)
    count = rng.integers(1, W + 1, (n, 1))
    dup = np.zeros((n, W), bool)
    dup[:, 1:] = keys[:, 1:] == keys[:, :-1]
    keys[dup | (np.arange(W)[None, :] >= count)] = INT32_PAD_KEY
    keys = np.sort(keys, axis=1).astype(np.int32)
    vals = np.where(keys != INT32_PAD_KEY,
                    rng.uniform(0.01, 0.5, (n, W)), 0.0).astype(np.float32)
    d = rng.uniform(0.4, 1.0, n).astype(np.float32)
    return {"src": src, "dst": dst, "keys": keys, "vals": vals, "d": d,
            "sqrt_c": float(np.sqrt(0.6)), "tau": 1e-6,
            "rng": np.random.default_rng(seed + 1)}


class Placer:
    """Tensors on ``device``: real ones, or under ``fake`` (a
    ``FakeTensorMode``) fake ones of the same shapes and dtypes."""

    def __init__(self, device, fake=None):
        self.device = torch.device(device)
        self.fake = fake

    def __call__(self, a, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.fake is None:
            return t.to(self.device)
        with self.fake:
            return torch.empty(t.shape, dtype=t.dtype, device=self.device)

    def layout(self, src, dst, w, n: int):
        """The CSR ``SpmmLayout`` of an edge list on the device."""
        from repro_torch.kernels.spmv_ell import SpmmLayout
        from repro_torch.kernels.spmv_ell.ops import HEAVY_DEGREE
        if self.fake is None:
            return SpmmLayout.from_edges(src, dst, w, n, self.device)
        heavy = int((np.bincount(dst, minlength=n) > HEAVY_DEGREE).sum())
        i32 = np.int32
        with self.fake:
            return SpmmLayout(
                n=n, in_ptr=self(np.zeros(n + 1, i32)),
                in_idx=self(np.zeros(len(src), i32)),
                w=self(np.zeros(len(src), np.float32)),
                heavy=self(np.zeros(heavy, i32)),
                light=self(np.zeros(n - heavy, i32)))


def placer(devices=None, default: str = "cpu") -> list:
    """One :class:`Placer` per device of ``devices`` (default
    ``[default]``), a ``meta`` device fake and the rest real; the fake
    ones share one ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    devices = [default] if devices is None else list(devices)
    mode = None
    out = []
    for dev in devices:
        dev = torch.device(dev)
        if dev.type == "meta" and mode is None:
            mode = FakeTensorMode()
        out.append(Placer(dev, mode if dev.type == "meta" else None))
    return out


def _table(p: Placer, inp: dict):
    return (p(inp["keys"]), p(inp["vals"]), p(inp["d"]))


def _pull_layout(p: Placer, inp: dict, n: int):
    from repro_torch.graph import csr
    g = csr.from_edges(n, inp["src"], inp["dst"])
    return p.layout(g.edge_src, g.edge_dst,
                    csr.normalized_pull_weights(g, inp["sqrt_c"]), n)


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------
def build_specs(device_count: int = N_SHARDS) -> list[ProgramSpec]:
    """Every program, as (devices -> (fn, args)) thunks. Specs with
    ``devices`` beyond ``device_count`` are still returned; the caller
    decides whether to skip or fail them (no pass of the port skips:
    its mesh devices are fake)."""
    uni = universe()
    g = _geometry(uni)
    n, W, E, l_max = g["n"], g["W"], g["E"], g["l_max"]
    B_src, B_pair, tile = (uni["source_batch"], uni["pair_batch"],
                           uni["join_tile"])

    def inputs():
        return host_inputs(n, g["deg"], W, l_max)

    def default(backend):
        return "meta:0" if backend == "kernel" else "cpu"

    specs: list[ProgramSpec] = []

    def pair_make(backend):
        def make(devices=None):
            (p,) = placer(devices, default(backend))
            inp = inputs()
            keys, vals, d = _table(p, inp)
            ids = inp["rng"].integers(0, n, (2, B_pair))
            if backend == "plain":
                from repro_torch.core.index import _pair_query_batch
                args = (keys, vals, d, p(ids[0], torch.int64),
                        p(ids[1], torch.int64))
                return (lambda *a: _pair_query_batch(*a, n=n)), args
            from repro_torch.kernels.hp_join import (fold_sqrt_d_arrays,
                                                     hp_join)
            folded = p(fold_sqrt_d_arrays(*(torch.as_tensor(inp[k]) for k
                                            in ("keys", "vals", "d"))))
            args = (keys, folded, p(ids[0], torch.int32),
                    p(ids[1], torch.int32))
            return hp_join, args
        return make

    pair_dims = (Dim("batch", B_pair, "engine-pair-batch"),
                 Dim("width", W, "cap-bucket"))
    specs.append(ProgramSpec(
        name="pair/plain", file="src/repro_torch/core/index.py",
        make=pair_make("plain"), dims=pair_dims, backend="plain"))
    specs.append(ProgramSpec(
        name="pair/kernel", file="src/repro_torch/serve/engine.py",
        make=pair_make("kernel"), dims=pair_dims, backend="kernel"))

    def push_make(backend, B, k=None):
        def make(devices=None):
            return push_program(n, g["deg"], W, l_max, B, backend, k,
                                devices)
        return make

    for backend in ("plain", "kernel"):
        specs.append(ProgramSpec(
            name=f"source/{backend}",
            file="src/repro_torch/core/single_source.py",
            make=push_make(backend, B_src),
            dims=(Dim("batch", B_src, "engine-source-batch"),
                  Dim("width", W, "cap-bucket")), backend=backend))

    for k in sorted({b for b in uni["k_buckets"] if b <= n} | {n}):
        specs.append(ProgramSpec(
            name=f"topk/plain/k={k}", file="src/repro_torch/core/topk.py",
            make=push_make("plain", B_src, k),
            dims=(Dim("batch", B_src, "engine-source-batch"),
                  Dim("k", k, "k-bucket")), backend="plain"))
    specs.append(ProgramSpec(
        name="topk/kernel/k=16", file="src/repro_torch/core/topk.py",
        make=push_make("kernel", B_src, 16),
        dims=(Dim("batch", B_src, "engine-source-batch"),
              Dim("k", 16, "k-bucket")), backend="kernel"))

    def join_make(devices=None):
        # the sweep's tile program (join/sweep._tile_runner) up to its
        # device tensors, on the backend the sweep resolves on the device
        from repro_torch.join.sweep import JoinConfig, _kq
        from repro_torch.kernels.horner_push import resolve_push_backend
        cfg = JoinConfig()
        backend = resolve_push_backend(cfg.push_backend,
                                       devices[0] if devices else "meta")
        return push_make(backend, cfg.tile, _kq(cfg, n))(devices)

    specs.append(ProgramSpec(
        name="join/tile", file="src/repro_torch/join/sweep.py",
        make=join_make,
        dims=(Dim("tile", tile, "join-tile"), Dim("k", 16, "k-bucket")),
        backend="kernel"))

    def walk_make(devices=None):
        from repro_torch.core import walks
        from repro_torch.graph import csr
        (p,) = placer(devices)
        inp = inputs()
        dg = walks.DeviceGraph.from_graph(
            csr.from_edges(n, inp["src"], inp["dst"]), edge_cap=E,
            device=p.device)
        lanes = walks.WALK_SPLIT_UNIT
        starts = inp["rng"].integers(0, n, (2, lanes))
        gen = torch.Generator(device=p.device).manual_seed(SEED)
        args = (dg.in_ptr, dg.in_idx, dg.in_deg, p(starts[0], torch.int64),
                p(starts[1], torch.int64))
        return (lambda *a: walks.paired_meet(
            *a, gen, inp["sqrt_c"], 10)), args

    specs.append(ProgramSpec(
        name="walk/paired_meet", file="src/repro_torch/core/walks.py",
        make=walk_make, dims=(Dim("edge_cap", E, "cap-bucket"),)))

    def pr_make(devices=None):
        # the prsim builder's reverse-PageRank step; the port pads its
        # edges to no bucket (prsim/pagerank.py)
        from repro_torch.graph import csr
        from repro_torch.prsim.pagerank import DEFAULT_DAMPING, _pr_step
        (p,) = placer(devices)
        gr = csr.from_edges(n, *(inputs()[k] for k in ("src", "dst")))
        deg = gr.in_deg.astype(np.int64)
        owner = np.repeat(np.arange(n), deg)
        args = (p(np.full(n, 1.0 / n, np.float32)),
                p(gr.in_idx.astype(np.int64)), p(owner),
                p((1.0 / np.maximum(deg, 1))[owner].astype(np.float32)),
                p((deg == 0).astype(np.float32)))
        return (lambda *a: _pr_step(*a, DEFAULT_DAMPING)), args

    specs.append(ProgramSpec(
        name="prsim/pr_step", file="src/repro_torch/prsim/pagerank.py",
        make=pr_make, dims=()))

    specs.extend(_sharded_specs(g, uni, inputs))
    return specs


def fake_args(args, device="meta:0") -> tuple:
    """Fake stand-ins for ``args`` on ``device`` under a new
    ``FakeTensorMode``: each tensor, and each array of an
    ``SpmmLayout``, at its shape and dtype; anything else as it is."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.spmv_ell import SpmmLayout
    mode = FakeTensorMode()
    dev = torch.device(device)

    def one(a):
        if isinstance(a, torch.Tensor):
            with mode:
                return torch.empty(a.shape, dtype=a.dtype, device=dev)
        if isinstance(a, SpmmLayout):
            with mode:
                return SpmmLayout(n=a.n, **{f: one(getattr(a, f)) for f in
                                            ("in_ptr", "in_idx", "w",
                                             "heavy", "light")})
        return a
    return tuple(one(a) for a in args)


def push_fn(backend: str, n: int, l_max: int, tau: float,
            k: int | None = None):
    """The single-source program (``k`` None: ``batched_single_source``)
    or the top-k one (``batched_topk``) over (keys, vals, d, layout,
    us), on ``backend``."""
    from repro_torch.core.single_source import batched_single_source
    from repro_torch.core.topk import batched_topk
    kw = dict(n=n, l_max=l_max, backend=backend)
    if k is None:
        return lambda *a: batched_single_source(*a, tau, **kw)
    return lambda *a: batched_topk(*a, tau, k=k, **kw)


def push_program(n: int, deg: int, W: int, l_max: int, B: int,
                 backend: str, k: int | None = None, devices=None):
    """(:func:`push_fn`, its arguments) on the seeded inputs of that
    geometry: the table, Â's CSR and B query ids, on ``devices``' one
    device (default: a fake ``meta:0`` for the kernel, the CPU for the
    plain push)."""
    (p,) = placer(devices, "meta:0" if backend == "kernel" else "cpu")
    inp = host_inputs(n, deg, W, l_max)
    us = inp["rng"].integers(0, n, B)
    args = (*_table(p, inp), _pull_layout(p, inp, n), p(us, torch.int64))
    return push_fn(backend, n, l_max, inp["tau"], k), args


def sharded_index(inp: dict, n: int, l_max: int, places: list):
    """A :class:`~repro_torch.core.shard_query.ShardedIndex` of the seeded
    table and graph over a 1-D mesh of ``places``' devices, each shard's
    rows, d and slab made on its device (the reference's placed
    arguments)."""
    from repro_torch.core import hp_index, shard_query
    from repro_torch.core.single_source import Slab
    from repro_torch.graph import csr
    S = len(places)
    mesh = shard_query.serving_mesh(S, devices=[p.device for p in places])
    n_pad, n_loc = hp_index.shard_layout(n, S)
    keys, vals = inp["keys"], inp["vals"]
    d = np.zeros(n_pad, np.float32)
    d[:n] = inp["d"]
    g = csr.from_edges(n, inp["src"], inp["dst"])
    w = csr.normalized_pull_weights(g, inp["sqrt_c"])
    shard = g.edge_dst // n_loc
    ks, xs, ds, slabs = [], [], [], []
    for s, p in enumerate(places):
        rows = slice(s * n_loc, (s + 1) * n_loc)
        ks.append(p(keys[rows]))
        xs.append(p(vals[rows]))
        ds.append(p(d[rows]))
        mine = shard == s
        slabs.append(Slab(
            layout=p.layout(g.edge_src[mine], g.edge_dst[mine] - s * n_loc,
                            w[mine], n_loc),
            d=ds[-1], start=s * n_loc, d_offset=s * n_loc))
    e_req = shard_query.required_edge_cap(g, S, n_loc)
    return shard_query.ShardedIndex(
        mesh=mesh, axis="data", n=n, n_pad=n_pad, n_loc=n_loc, n_shards=S,
        l_max=l_max, tau=float(np.float32(inp["tau"])),
        width_cap=keys.shape[1],
        edge_cap=hp_index.capacity_bucket(e_req), keys=ks, vals=xs, d=ds,
        slabs=slabs)


def _sharded_specs(g: dict, uni: dict, inputs) -> list[ProgramSpec]:
    """The 4 fan-out programs of ``core/shard_query.py`` on a 2-position
    mesh: stages 1-2 (``sharded_scores``) and, for top-k, the merge
    (``_merge_topk``)."""
    n, W, l_max = g["n"], g["W"], g["l_max"]
    B = uni["source_batch"]
    file = "src/repro_torch/core/shard_query.py"

    def make_factory(backend: str, topk: bool):
        def make(devices=None):
            from repro_torch.core import shard_query
            places = placer(devices or [f"meta:{s}"
                                        for s in range(N_SHARDS)])
            inp = inputs()
            si = sharded_index(inp, n, l_max, places)
            us = places[0](inp["rng"].integers(0, n, B), torch.int64)

            def fn(us):
                outs = shard_query.sharded_scores(si, us, backend)
                if not topk:
                    return outs
                return shard_query._merge_topk(outs, si.n, si.n_loc, 16,
                                               si.devices[0])
            return fn, (us,)
        return make

    out = []
    for backend in ("plain", "kernel"):
        for topk in (False, True):
            kind = "topk" if topk else "source"
            dims = [Dim("batch", B, "engine-source-batch"),
                    Dim("width", W, "cap-bucket")]
            if topk:
                dims.append(Dim("k", 16, "k-bucket"))
            out.append(ProgramSpec(
                name=f"sharded-{kind}/{backend}", file=file,
                make=make_factory(backend, topk), dims=tuple(dims),
                devices=N_SHARDS, backend=backend))
    return out
