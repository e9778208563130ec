"""Index construction: plan -> diagonal (Alg 4) -> HP table (Alg 2).

Port of ``repro/core/build.py``. The walks and the HP builds run on
``device`` (``cuda`` unless the caller passes ``device="cpu"``), or,
with ``mesh=``, split over the shards of a mesh axis;
``exact_d=True`` takes the power-method diagonal on the host instead of
the walks.

  * ``build_index`` builds in memory: the dense blocked table
    (``builder="sling"``, with ``spill_dir`` for out-of-core assembly)
    or the prsim hub/tail schedule over the sparse build;
  * ``build_index_scale`` builds straight to a v3 file: the chunked
    certified diagonal, the sparse or prsim schedule into a
    ``_CooSink``, then ``index.pack_coo_to_v3``, so the packed (n,
    width) arrays never exist whole -- the million-node path, served
    with ``SlingIndex.load(path, mmap=True)``.

``builder="auto"`` measures the in-degree skew (``graph/stats.py``) and
picks prsim on power-law graphs; both builders emit the same entries.
``update_index`` is the facade over ``core/update.py``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import (diagonal, hp_index, optimizations, theory,
                              update, walks)
from repro_torch.core.index import SlingIndex, pack_coo_to_v3
from repro_torch.device import resolve_device, synchronize
from repro_torch.graph import csr, stats
from repro_torch.launch.mesh import mesh_device


def resolve_builder(g: csr.Graph, builder: str,
                    mesh=None) -> tuple[str, object]:
    """``(backend, SkewStats or None)`` for a ``builder=`` argument:
    "auto" measures the skew and picks "prsim" on measurably power-law
    graphs, "sling" otherwise -- except under a mesh, where the sharded
    dense build is the only mesh-aware construction, so "auto" stays
    "sling" and "prsim" is refused; "sling" and "prsim" are taken as
    given."""
    if builder == "auto":
        if mesh is not None:
            return "sling", None
        return stats.choose_builder(g)
    if builder not in ("sling", "prsim"):
        raise ValueError(f"unknown builder {builder!r}; expected "
                         "'auto', 'sling', or 'prsim'")
    if builder == "prsim" and mesh is not None:
        raise ValueError("the prsim builder is a sparse host-driven "
                         "schedule; mesh builds use builder='sling'")
    return builder, None


def _prsim_hp_table(g: csr.Graph, p: theory.SlingPlan,
                    spill_dir: str | None, verbose: bool, device):
    """In-memory prsim build: the hub/tail schedule into a sink, packed
    on ``device`` (entry for entry the sparse SLING schedule's)."""
    from repro_torch import prsim
    sink = hp_index._CooSink(spill_dir, tag="hp_prsim")
    pstats = prsim.build_prsim_coo(g, p, sink, progress=verbose,
                                   device=device)
    src, key, val = sink.collect(device)
    hp = hp_index._pack_coo(src, key, val, g.n, p.theta, p.sqrt_c, p.l_max)
    return hp, pstats


def build_index(g: csr.Graph, eps: float = 0.025,
                delta: float | None = None, c: float = 0.6, seed: int = 0,
                adaptive: bool = True, block: int = 256,
                spill_dir: str | None = None, space_reduce: bool = False,
                enhance: bool = False, exact_d: bool = False,
                stale_frac: float = 0.0, quant_frac: float = 0.0,
                builder: str = "sling", mesh=None, mesh_axis: str = "data",
                *, device=None, verbose: bool = False) -> SlingIndex:
    """The reference's positional order through ``mesh_axis``. ``delta``
    is the failure probability of the walk diagonal (``None``: 1/n) and
    ``adaptive`` picks Algorithm 4 over the fixed-budget Algorithm 1
    (``theory.plan``, ``diagonal.estimate_diagonal``). ``spill_dir``
    writes the HP blocks' triples to spill files instead of holding
    them. ``stale_frac`` reserves that share of eps for the staleness
    that ``update_index`` batches spend, and ``quant_frac`` a share for
    ``quantize.quantize_index`` (``theory.plan``'s ``eps_quant_frac``).
    ``space_reduce`` and ``enhance`` apply the Section-5.2 and 5.3
    optimizations (``core/optimizations.py``) on the host after the
    build. ``builder``: "sling" (the dense blocked table), "prsim" (the
    hub/tail schedule over the sparse build) or "auto" (by in-degree
    skew); the choice is recorded in the index.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) shards the build
    over ``mesh.shape[mesh_axis]``: the walk chunks
    (``estimate_diagonal(mesh=)``) and the HP table's seed columns
    (``hp_index.shard_build_hp``), each equal to the unsharded build's
    bit for bit. The index then lies on the axis's first device, which
    ``device`` must be if given."""
    backend, skew = resolve_builder(g, builder, mesh=mesh)
    if mesh is not None:
        device = mesh_device(mesh, mesh_axis, device)
        if not exact_d:
            walks.check_walk_mesh(mesh, mesh_axis, walks.DEFAULT_CHUNK)
    dev = resolve_device(device)
    if verbose and builder == "auto":
        print(f"build_index: auto-selected builder={backend}"
              + ("" if skew is None else f" skew={skew.as_row()}"))
    p = theory.plan(eps=eps, delta=delta, c=c, n=g.n,
                    stale_frac=stale_frac, eps_quant_frac=quant_frac)
    t0 = time.perf_counter()
    if exact_d:
        d = diagonal.exact_diagonal(g, c)
    else:
        d = diagonal.estimate_diagonal(g, p, seed=seed, adaptive=adaptive,
                                       mesh=mesh, mesh_axis=mesh_axis,
                                       device=dev, verbose=verbose)
    t1 = time.perf_counter()
    if backend == "prsim":
        hp, _ = _prsim_hp_table(g, p, spill_dir, verbose, dev)
    elif mesh is not None:
        hp = hp_index.shard_build_hp(g, theta=p.theta, sqrt_c=p.sqrt_c,
                                     l_max=p.l_max, mesh=mesh,
                                     axis=mesh_axis, block=block,
                                     spill_dir=spill_dir, progress=verbose)
    else:
        hp = hp_index.build_hp_table(g, theta=p.theta, sqrt_c=p.sqrt_c,
                                     l_max=p.l_max, block=block,
                                     spill_dir=spill_dir, progress=verbose,
                                     device=dev)
    synchronize(dev)
    t2 = time.perf_counter()
    idx = SlingIndex(plan=p, d=torch.as_tensor(d, dtype=torch.float32,
                                               device=dev), hp=hp,
                     builder=backend,
                     build_seconds={"d": t1 - t0, "hp": t2 - t1})
    if space_reduce:
        optimizations.apply_space_reduction(idx, g)
    if enhance:
        optimizations.mark_for_enhancement(idx, g)
    if verbose:
        print(f"build_index: builder={backend} d={t1 - t0:.2f}s "
              f"hp={t2 - t1:.2f}s entries={int(hp.counts.sum())} "
              f"width={hp.width} bytes={idx.nbytes()}"
              + ("" if mesh is None else
                 f" mesh={mesh.shape[mesh_axis]}-way over '{mesh_axis}'"))
    return idx


def approx_diagonal_degree(g: csr.Graph, c: float) -> np.ndarray:
    """O(n) degree-based diagonal, d_k ~= 1 - c/|I(k)| (1.0 for
    in-degree 0): Eq. 15 without the mu_k term. UNCERTIFIED -- the walk
    estimator's eps_d bound does not apply -- so it sits behind
    ``build_index_scale(uncertified_diagonal=True)``, is recorded in the
    artifact header, and ``QueryEngine`` refuses it unless
    ``EngineConfig(allow_uncertified=True)``."""
    deg = np.maximum(g.in_deg, 1).astype(np.float64)
    d = np.where(g.in_deg > 0, 1.0 - c / deg, 1.0)
    return d.astype(np.float32)


def build_index_scale(g: csr.Graph, path: str, eps: float = 0.1,
                      delta: float | None = None, c: float = 0.6,
                      seed: int = 0, quant_frac: float = 0.2,
                      quantize: str | None = "int16",
                      builder: str = "auto", d_mode: str = "estimate",
                      d_shard: int = diagonal.DEFAULT_D_SHARD,
                      uncertified_diagonal: bool = False,
                      block: int = 4096, spill_dir: str | None = None,
                      row_chunk: int = 1 << 16, verbose: bool = False, *,
                      device=None) -> dict:
    """Out-of-core build straight to a v3 file at ``path``: the walks
    and the sparse (or prsim) propagation on ``device`` (``cuda`` unless
    ``device="cpu"``), the triples gathered on the host and streamed
    through ``pack_coo_to_v3``. Serve it with ``SlingIndex.load(path,
    mmap=True)``.

    ``builder``: "auto" (by in-degree skew; power-law graphs get the
    prsim schedule), "sling" or "prsim"; recorded in the header.
    ``d_mode``: "estimate" (the chunked certified Alg 4 over
    ``d_shard``-node shards) or "exact" (power method, tiny graphs).
    The O(n) degree approximation is not a ``d_mode``: it voids the eps
    certificate, so it needs ``uncertified_diagonal=True``, which the
    header records and serving refuses unless allowed.

    Returns ``pack_coo_to_v3``'s stats plus ``d_mode``, the d, hp and
    pack wall seconds, the skew row ("auto") and the prsim stats."""
    if d_mode == "degree":
        raise ValueError(
            "d_mode='degree' is gone: the degree approximation is "
            "uncertified. Pass uncertified_diagonal=True explicitly "
            "(recorded in the artifact and refused at serve time "
            "unless allowed; DESIGN.md section 15)")
    dev = resolve_device(device)
    backend, skew = resolve_builder(g, builder)
    if verbose and builder == "auto":
        print(f"build_index_scale: auto-selected builder={backend} "
              f"skew={skew.as_row()}")
    p = theory.plan(eps=eps, delta=delta, c=c, n=g.n,
                    eps_quant_frac=quant_frac)
    t0 = time.perf_counter()
    if uncertified_diagonal:
        d = approx_diagonal_degree(g, c)
        d_mode = "degree"
    elif d_mode == "exact":
        d = diagonal.exact_diagonal(g, c).astype(np.float32)
    elif d_mode == "estimate":
        d = diagonal.estimate_diagonal_chunked(g, p, seed=seed,
                                               shard=d_shard, device=dev,
                                               verbose=verbose)
    else:
        raise ValueError(f"unknown d_mode {d_mode!r}")
    t1 = time.perf_counter()
    sink = hp_index._CooSink(spill_dir, tag="hp_scale")
    pstats = None
    if backend == "prsim":
        from repro_torch import prsim
        pstats = prsim.build_prsim_coo(g, p, sink, progress=verbose,
                                       device=dev)
    else:
        hp_index.sparse_hp_coo(g, p.theta, p.sqrt_c, p.l_max, block, sink,
                               progress=verbose, device=dev)
    src, key, val = (t.numpy() for t in sink.collect())
    t2 = time.perf_counter()
    out = pack_coo_to_v3(path, p, d, src, key, val, g.n,
                         quantize=quantize, row_chunk=row_chunk,
                         builder=backend,
                         uncertified_d=uncertified_diagonal)
    t3 = time.perf_counter()
    out.update(d_mode=d_mode, d_wall_s=t1 - t0, hp_wall_s=t2 - t1,
               pack_wall_s=t3 - t2)
    if skew is not None:
        out["skew"] = skew.as_row()
    if pstats is not None:
        out["prsim"] = pstats.as_row()
    if verbose:
        print(f"build_index_scale: builder={backend} d={t1 - t0:.2f}s "
              f"({d_mode}) hp={t2 - t1:.2f}s pack={t3 - t2:.2f}s "
              f"entries={out['entries']} bytes={out['bytes']}")
    return out


def update_index(idx: SlingIndex, g: csr.Graph, delta, seed: int = 0,
                 exact_d: bool = False, theta_r: float | None = None,
                 block: int = 256, verbose: bool = False):
    """Incremental maintenance: apply a :class:`~repro_torch.graph.csr.
    GraphDelta` to ``idx`` in place without a full rebuild; returns the
    ``UpdateReport`` (new graph, affected nodes for
    ``QueryEngine.swap_index``, staleness, ``needs_rebuild``). Build
    with ``stale_frac > 0`` to reserve the budget updates spend."""
    return update.update_index(idx, g, delta, seed=seed, exact_d=exact_d,
                               theta_r=theta_r, block=block,
                               verbose=verbose)
