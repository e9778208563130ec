"""Node-sharded SLING serving: the sharded index and the single-source /
top-k fan-out over one mesh axis.

Port of ``repro/core/shard_query.py``. SLING's O(n/eps) single-source
bound holds per device; to serve an index larger than one device holds,
the index is cut into node slabs. Shard s of an S-way mesh axis owns
the nodes [s*n_loc, (s+1)*n_loc) and holds, on its device:

  * its slab of packed HP rows (``hp_index.pad_packed_rows``),
  * its slice of the diagonal correction vector d,
  * every graph edge whose *destination* lies in the slab, as a CSR
    over the slab's rows whose sources are global node ids
    (``single_source.Slab``).

Which dimension each of these splits is ``launch/sharding.
sling_index_specs``. The reference runs the fan-out inside one
``shard_map`` program; the port is single-controller: the calling
thread runs the shards in order, and a collective is plain torch ops in
shard order.

  1. **row fetch** -- with every shard on one device, none: the push
     reads each query's row through its id from the shard that owns it
     (the shards' tables are its row source). Across devices, the psum
     fetch: the (B,) query ids are replicated; each shard contributes
     the packed rows it owns and exact zeros elsewhere, and the
     contributions are summed. The owner is unique, so the sum *is* the
     row, the INT32_PAD_KEY sentinel included.
  2. **Horner push over the slabs** -- each slab seeds only its targets
     from its d slice and writes its rows of a level into the node-major
     frontier that every slab reads at the next. Every shard on one
     device: one launch of the Hopper kernel ``horner_push_slabs`` over
     every level and every slab, where the frontier is gathered as it is
     written (``single_source.slab_push``). Across devices: one launch a
     level a device, each device's rows copied into the others' frontier
     between levels (``single_source.slab_horner_push``).
  3. **merge** -- single-source concatenates the slabs in shard order;
     top-k, with every shard on one device, is one stable top-k over the
     concatenated rows below n; across devices it takes a stable
     top-min(k, n_loc) of each slab, pad rows (id >= n) masked to -1
     below every real score, and merges the candidates, gathered in
     shard order, with a second stable sort. Shard order is id order,
     so equal scores still go to the smaller node id, as on one device.

Shapes are swap-stable in the engine's sense: rows are padded to
``width_cap``, a capacity bucket (``hp_index.capacity_bucket``) that a
hot swap passes back as a floor; a swap that fits it adds no dispatch
shape. ``edge_cap`` is the reference's per-shard edge bucket, kept as a
recorded number only: each slab's CSR is built at its exact size, and
the port has no compiled program whose shape it would fix.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hp_index
from repro_torch.core.single_source import (Slab, prune_tau,
                                            slab_device, slab_horner_push,
                                            slab_push, slab_views)
from repro_torch.core.topk import stable_topk
from repro_torch.graph import csr
from repro_torch.kernels.cost import collective
from repro_torch.kernels.horner_push import resolve_push_backend
from repro_torch.kernels.spmv_ell import SpmmLayout
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.sharding import place, sling_index_specs


def serving_mesh(n_shards: int, axis: str = "data", devices=None):
    """1-D serving mesh over the first ``n_shards`` CUDA devices (raises
    if there are fewer), or over ``devices``, which may repeat one
    (``["cuda:0"] * 4``, ``["cpu"] * 4``)."""
    if devices is None and torch.cuda.device_count() < n_shards:
        raise RuntimeError(
            f"mesh needs {n_shards} CUDA devices, found "
            f"{torch.cuda.device_count()}; pass devices= to place "
            "several shards on one device")
    return make_debug_mesh((n_shards,), (axis,), devices=devices)


def required_edge_cap(g: csr.Graph, n_shards: int, n_loc: int) -> int:
    """Largest per-shard dst-partitioned edge count (>= 1)."""
    if g.m == 0:
        return 1
    counts = np.bincount(g.edge_dst // n_loc, minlength=n_shards)
    return int(counts.max())


def partition_edges(g: csr.Graph, sqrt_c: float, n_shards: int,
                    n_loc: int, edge_cap: int):
    """Group the pull-oriented edge list by destination shard, as the
    reference does: (blk_src, blk_dstl, blk_w), each (n_shards,
    edge_cap) NumPy -- global source ids, slab-local destination ids,
    pull weights sqrt(c)/|I(dst)| -- each shard's edges in edge-list
    order, then pad slots (src 0, dst_local 0, weight 0)."""
    if edge_cap < required_edge_cap(g, n_shards, n_loc):
        raise ValueError("edge_cap below the largest shard block")
    w = csr.normalized_pull_weights(g, sqrt_c)
    shard = g.edge_dst // n_loc
    counts = np.bincount(shard, minlength=n_shards)
    order = np.argsort(shard, kind="stable")
    bs = np.zeros((n_shards, edge_cap), np.int32)
    bdl = np.zeros((n_shards, edge_cap), np.int32)
    bw = np.zeros((n_shards, edge_cap), np.float32)
    off = 0
    for s in range(n_shards):
        es = order[off:off + counts[s]]
        off += counts[s]
        bs[s, :len(es)] = g.edge_src[es]
        bdl[s, :len(es)] = g.edge_dst[es] - s * n_loc
        bw[s, :len(es)] = w[es]
    return bs, bdl, bw


@dataclasses.dataclass
class ShardedIndex:
    """A SLING index cut into node slabs over one mesh axis: per shard,
    on its device, the (n_loc, width_cap) packed rows, the (n_loc,) d
    slice and the slab's in-edges (:class:`~repro_torch.core.
    single_source.Slab`)."""
    mesh: object
    axis: str
    n: int
    n_pad: int
    n_loc: int
    n_shards: int
    l_max: int
    tau: float           # resolved Horner prune threshold (prune_tau)
    width_cap: int       # packed-row capacity bucket
    edge_cap: int        # per-shard edge bucket: recorded, shapes nothing
    keys: list           # S x (n_loc, width_cap) int32
    vals: list           # S x (n_loc, width_cap) float32
    d: list              # S x (n_loc,) float32
    slabs: list          # S x single_source.Slab

    @property
    def devices(self) -> tuple:
        return tuple(k.device for k in self.keys)

    @property
    def one_device(self) -> bool:
        """Every shard on one device: the push is one call and reads the
        shards' own tables (the fan-out's route)."""
        return slab_device(self.slabs) is not None

    def nbytes_per_shard(self) -> int:
        """Device bytes each shard holds on average (the memory-scaling
        claim): rows, d and the slab's CSR."""
        ts = [*self.keys, *self.vals, *self.d]
        for sl in self.slabs:
            lay = sl.layout
            ts += [lay.in_ptr, lay.in_idx, lay.w, lay.push_order]
        return sum(t.numel() * t.element_size() for t in ts) // self.n_shards


def shard_index(idx, g: csr.Graph, mesh, axis: str = "data",
                width_cap: int | None = None, edge_cap: int | None = None,
                cap_quantum: int = 64,
                headroom: float = 1.25) -> ShardedIndex:
    """Cut a built SlingIndex and its graph over ``mesh.shape[axis]``
    shards (``launch/sharding.sling_index_specs``), wherever the
    index's storage lies (a mapped file is read from host memory; a
    quantized index is dequantized first).

    ``width_cap`` and ``edge_cap`` are capacity-bucket floors: pass the
    previous ShardedIndex's on a hot swap to keep its row shape. Where
    the index outgrows a floor, the cap grows to ``hp_index.
    capacity_bucket`` of the need; callers that care (``QueryEngine``)
    see a width growth. ``edge_cap`` is only recorded (module
    docstring): the slabs' CSRs take their exact sizes."""
    specs = sling_index_specs(axis)
    S = int(mesh.shape[axis])
    n_pad, n_loc = hp_index.shard_layout(idx.n, S)
    wc = int(width_cap or 0)
    if wc < idx.hp.width:
        wc = hp_index.capacity_bucket(idx.hp.width, cap_quantum, headroom)
    ec = int(edge_cap or 0)
    e_req = required_edge_cap(g, S, n_loc)
    if ec < e_req:
        ec = hp_index.capacity_bucket(e_req, cap_quantum, headroom)
    keys, vals = hp_index.pad_packed_rows(idx.dequantized_hp(), n_pad, wc)
    d = torch.zeros(n_pad, dtype=torch.float32, device=idx.d.device)
    d[:idx.n] = idx.d.to(torch.float32)
    w = csr.normalized_pull_weights(g, idx.plan.sqrt_c)
    shard = g.edge_dst // n_loc
    devices = mesh.axis_devices(specs["edges"][0])
    d_s = place(d, specs["d"], mesh)
    slabs = []
    for s, dev in enumerate(devices):
        mine = shard == s
        slabs.append(Slab(
            layout=SpmmLayout.from_edges(g.edge_src[mine],
                                         g.edge_dst[mine] - s * n_loc,
                                         w[mine], n_loc, dev),
            d=d_s[s], start=s * n_loc, d_offset=s * n_loc))
    return ShardedIndex(
        mesh=mesh, axis=axis, n=idx.n, n_pad=n_pad, n_loc=n_loc,
        n_shards=S, l_max=idx.plan.l_max,
        tau=float(np.float32(prune_tau(idx.plan))), width_cap=wc,
        edge_cap=ec, keys=place(keys, specs["keys"], mesh),
        vals=place(vals, specs["vals"], mesh), d=d_s, slabs=slabs)


# ----------------------------------------------------------------------
# the fan-out
# ----------------------------------------------------------------------
def _resolve_si_backend(si: ShardedIndex, backend: str | None) -> str:
    """The push backend of a ShardedIndex, resolved on its first device:
    "auto"/None is the kernel on ``cuda``, the plain push on the CPU.
    There is no quiet fallback: an unknown name raises, and on ``cuda``
    the kernel launches or raises."""
    return resolve_push_backend(backend, si.devices[0])


def _query_rows(si: ShardedIndex, us: torch.Tensor):
    """psum row fetch: each shard's rows of ``us`` where it owns them,
    exact zeros elsewhere, summed in shard order on the first device.
    The owner is unique, so the sum is the row (int32 keys add 0)."""
    home = si.devices[0]
    ku = xu = None
    reps = place(us, sling_index_specs(si.axis)["queries"], si.mesh,
                 si.axis)
    for s, (keys, vals, u) in enumerate(zip(si.keys, si.vals, reps)):
        u = u - s * si.n_loc
        mine = ((u >= 0) & (u < si.n_loc))[:, None]
        uc = u.clamp(0, si.n_loc - 1)
        with collective("all-reduce"):
            k = torch.where(mine, keys[uc], 0).to(home, non_blocking=True)
            x = torch.where(mine, vals[uc], 0.0).to(home, non_blocking=True)
        ku, xu = (k, x) if ku is None else (ku + k, xu + x)
    return ku, xu


def _ids(si: ShardedIndex, us) -> torch.Tensor:
    """The query ids as int64 on the first shard's device: host ids are
    copied there, ids already there (a tensor) are taken as they are."""
    if isinstance(us, torch.Tensor):
        return us.to(si.devices[0], torch.int64)
    return torch.as_tensor(np.atleast_1d(np.asarray(us, np.int64)),
                           device=si.devices[0])


def _one_device_push(si: ShardedIndex, us: torch.Tensor,
                     backend: str) -> torch.Tensor:
    """Every shard on one device: the (n_pad, B) node-major scores of
    one push with no row fetch -- it reads each id's row from the shard
    that owns it (``single_source.slab_push``, one launch on ``cuda``)."""
    rows = [(k, v, s * si.n_loc)
            for s, (k, v) in enumerate(zip(si.keys, si.vals))]
    return slab_push(rows, us, si.slabs, si.tau, n=si.n, l_max=si.l_max,
                     backend=backend)


def sharded_scores(si: ShardedIndex, us, backend: str | None = None
                   ) -> list:
    """Stages 1 and 2 of the fan-out: (B,) ids -> per shard its (n_loc,
    B) node-major slab scores, on its device. Every shard on one device:
    one push with no row fetch (views of its one buffer). Shards on
    several devices: the psum row fetch, then ``slab_horner_push``."""
    us = _ids(si, us)
    backend = _resolve_si_backend(si, backend)
    if si.one_device:
        return slab_views(_one_device_push(si, us, backend), si.slabs)
    ku, xu = _query_rows(si, us)
    return slab_horner_push(ku, xu, si.slabs, si.tau, n=si.n,
                            l_max=si.l_max, backend=backend)


def sharded_single_source(si: ShardedIndex, us,
                          backend: str | None = None) -> np.ndarray:
    """Batched single-source over the mesh: (B,) ids -> (B, n) float32
    NumPy. ``backend``: "auto"/None | "kernel" | "plain"."""
    if si.one_device:
        full = _one_device_push(si, _ids(si, us),
                                _resolve_si_backend(si, backend))
    else:
        full = torch.cat([o.to(si.devices[0], non_blocking=True)
                          for o in sharded_scores(si, us, backend)])
    return full[:si.n].t().cpu().numpy()


def _merge_topk(outs: list, n: int, n_loc: int, k: int, home):
    """The exact top-k merge of the slabs' (n_loc, B) scores ``outs``
    (slab s holds the ids [s*n_loc, (s+1)*n_loc)), on several devices:
    a stable top-min(k, n_loc) of each slab, pad rows (id >= n) masked
    to -1 below every real score, then the candidates, gathered on
    ``home`` in shard order, through a second stable sort. Shard order
    is id order, so equal scores keep the smaller id first."""
    k_loc = min(k, n_loc)
    cand_v, cand_i = [], []
    for s, out in enumerate(outs):
        gids = s * n_loc + torch.arange(n_loc, device=out.device)
        masked = torch.where(gids[None, :] < n, out.t(), -1.0)
        v, i = stable_topk(masked, k_loc)
        with collective("all-gather"):
            cand_v.append(v.to(home, non_blocking=True))
            cand_i.append((i + s * n_loc).to(home, non_blocking=True))
    vc, gc = torch.cat(cand_v, dim=1), torch.cat(cand_i, dim=1)
    v, pos = torch.sort(vc, dim=1, descending=True, stable=True)
    return v[:, :k], gc.gather(1, pos[:, :k])


def sharded_topk(si: ShardedIndex, us, k: int,
                 backend: str | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Batched top-k over the mesh, k clamped to n: ((B, k) float32
    scores descending, (B, k) int32 node ids) as NumPy, ties toward the
    smaller id -- the contract of ``topk_device``. Every shard on one
    device: one stable top-k over the rows below n, in id order. Shards
    on several devices: the merge of each slab's candidates
    (:func:`_merge_topk`), which cover its part of the global top-k, so
    both give the same answer."""
    k = max(1, min(int(k), si.n))
    if si.one_device:
        full = _one_device_push(si, _ids(si, us),
                                _resolve_si_backend(si, backend))
        v, i = stable_topk(full[:si.n].t(), k)
    else:
        v, i = _merge_topk(sharded_scores(si, us, backend), si.n,
                           si.n_loc, k, si.devices[0])
    return v.cpu().numpy(), i.cpu().numpy()
