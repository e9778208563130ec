"""Paired sqrt(c)-walks on the device (paper Section 4.1).

Port of ``repro/core/walks.py``. A sqrt(c)-walk stops at each step with
probability 1 - sqrt(c), otherwise it moves to a uniformly random
*in*-neighbor. Lemma 3: s(u, v) = P[two independent walks from u and v
meet at some common step]. Walks are capped at ``t_max`` steps; the
tail (sqrt c)^t_max is reserved in the plan's eps_d (``theory.plan``).

The reference runs every lane for all ``t_max`` steps under an alive
mask (``lax.scan``). Here a Python loop over steps drops the pairs that
are finished -- met, or one walk stopped (a stopped walk can never meet
again) -- so each step touches only the live pairs: after t steps a
fraction c^t of them. Random numbers come from an explicit
``torch.Generator`` on the walk's device; they do not match JAX's
stream, so the port is held to the eps_d certificate instead.

With a mesh (:func:`paired_meet`'s ``mesh``) the walk compute of every
step is split over the shards of one mesh axis, the graph replicated on
each shard's device; the random numbers are drawn once, on the first
shard's device, and then split, so the meet indicators equal the
unsharded walk's bit for bit.

``walk_positions`` (whole trajectories) and ``estimate_simrank_by_walks``
(the Lemma-3 estimator, over ``paired_meet_chunked``) are test oracles.
They draw from torch's generator too, so tests hold them to Lemma 3's
facts rather than to the reference's bits.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import csr

# pairs per walk dispatch (lanes of one chunk)
DEFAULT_CHUNK = 1 << 23
# the reference's smallest walk bucket (WALK_CHUNK_MIN): a walk mesh axis
# must divide it and the chunk (check_walk_mesh), so that both packages
# accept the same meshes
WALK_SPLIT_UNIT = 1 << 10


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident in-CSR used by the walks."""
    n: int
    m: int
    in_ptr: torch.Tensor   # (n+1,) int64
    in_idx: torch.Tensor   # (m+1,) int64, last slot is padding
    in_deg: torch.Tensor   # (n,) int64

    @staticmethod
    def from_graph(g: csr.Graph, edge_cap: int | None = None, *,
                   device=None) -> "DeviceGraph":
        """``g`` on ``device`` (``cuda`` unless ``device="cpu"``).
        ``in_idx`` holds ``edge_cap`` slots (m when None) and one more:
        a degree-0 node's pointer may equal m. The reference pads to an
        XLA shape bucket; eager torch needs none, but takes any
        ``edge_cap >= m`` the same way (walks never read past ``in_ptr[v]
        + in_deg[v]``, so pad slots are inert) and refuses a smaller
        one."""
        dev = resolve_device(device)
        cap = g.m if edge_cap is None else int(edge_cap)
        if cap < g.m:
            raise ValueError(f"edge_cap {cap} is below the graph's m = "
                             f"{g.m}")
        in_idx = torch.zeros(cap + 1, dtype=torch.int64)
        in_idx[:g.m] = torch.from_numpy(g.in_idx.astype("int64"))
        ptr = torch.from_numpy(g.in_ptr.astype("int64"))
        return DeviceGraph(n=g.n, m=g.m, in_ptr=ptr.to(dev),
                           in_idx=in_idx.to(dev),
                           in_deg=(ptr[1:] - ptr[:-1]).to(dev))

    @property
    def device(self) -> torch.device:
        return self.in_ptr.device

    def to(self, device) -> "DeviceGraph":
        """The same graph on ``device`` (itself when already there)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return DeviceGraph(n=self.n, m=self.m,
                           in_ptr=self.in_ptr.to(device),
                           in_idx=self.in_idx.to(device),
                           in_deg=self.in_deg.to(device))


def check_walk_mesh(mesh, mesh_axis: str, chunk: int) -> None:
    """Refuse, before any walk runs, a mesh axis whose size does not
    divide both ``WALK_SPLIT_UNIT`` and ``chunk`` (a power-of-two shard
    count divides both): the reference's rule."""
    S = int(mesh.shape[mesh_axis])
    if WALK_SPLIT_UNIT % S or chunk % S:
        raise ValueError(
            f"walk sharding needs mesh axis '{mesh_axis}' (size {S}) "
            f"to divide both WALK_SPLIT_UNIT={WALK_SPLIT_UNIT} and "
            f"chunk={chunk}: use a power-of-two shard count (or a "
            "divisible chunk)")


def default_t_max(sqrt_c: float, tail: float = 1e-4) -> int:
    """Smallest t with (sqrt_c)^t <= tail."""
    return max(1, int(math.ceil(math.log(tail) / math.log(sqrt_c))))


def in_edge_offsets(dg: DeviceGraph, nodes: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Uniform in-edge position of each node from uniforms ``u`` in
    [0, 1); a node of in-degree 0 gets position 0, which callers mask."""
    deg = dg.in_deg[nodes]
    return torch.minimum((u * deg).long(), deg - 1).clamp_(min=0)


def uniform_in_neighbor(dg: DeviceGraph, nodes: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """The in-neighbor of each node at its uniform in-edge position."""
    return dg.in_idx[dg.in_ptr[nodes] + in_edge_offsets(dg, nodes, u)]


def _advance(dg: DeviceGraph, pa, pb, r, sqrt_c: float):
    """One step of the live pairs (pa, pb) with uniforms ``r`` (4, W):
    (go, the new positions, hit), where go says both walks moved."""
    go = ((r[0] < sqrt_c) & (dg.in_deg[pa] > 0)
          & (r[2] < sqrt_c) & (dg.in_deg[pb] > 0))
    pa = uniform_in_neighbor(dg, pa, r[1])
    pb = uniform_in_neighbor(dg, pb, r[3])
    return go, pa, pb, go & (pa == pb)


def _advance_split(dgs: list, mesh, mesh_axis: str, pa, pb, r,
                   sqrt_c: float):
    """:func:`_advance` with the lanes split over the walk spec
    (``launch/sharding.sling_build_specs``), one contiguous part a
    shard on its device (``dgs``: the graph there), the results
    concatenated back on the first device in shard order."""
    from repro_torch.launch.sharding import place, sling_build_specs
    spec = sling_build_specs(mesh_axis)["walks"]
    home = pa.device
    parts = []
    for dg, ia, ib, ir in zip(dgs, place(pa, spec, mesh),
                              place(pb, spec, mesh),
                              place(r.t(), spec, mesh)):
        out = _advance(dg, ia, ib, ir.t(), sqrt_c)
        parts.append([t.to(home, non_blocking=True) for t in out])
    return tuple(torch.cat(ts) for ts in zip(*parts))


def paired_meet(dg_in_ptr: torch.Tensor, dg_in_idx: torch.Tensor,
                dg_in_deg: torch.Tensor, start_a: torch.Tensor,
                start_b: torch.Tensor, gen: torch.Generator,
                sqrt_c: float, t_max: int, *, mesh=None,
                mesh_axis: str = "data") -> torch.Tensor:
    """Run paired sqrt(c)-walks over a :class:`DeviceGraph`'s arrays;
    bool (W,) of the pairs that ever meet. The reference's positional
    order, a ``torch.Generator`` (on the arrays' device) where it takes
    a key.

    A pair meets at step l >= 0 if both walks are alive and co-located;
    pairs with start_a == start_b meet at step 0 (callers that follow
    Alg 1 filter those out themselves).

    ``mesh`` splits each step's live pairs over ``mesh.shape[mesh_axis]``
    shards, with the graph replicated on every shard's device
    (``diagonal.estimate_diagonal`` runs :func:`check_walk_mesh` first).
    The uniforms of a step are drawn once on the arrays' device, as
    without a mesh, and split with the pairs, so the result equals the
    unsharded walk's bit for bit.
    """
    # m: the edge slots (the walk steps read only the three arrays)
    dg = DeviceGraph(n=dg_in_deg.numel(), m=dg_in_idx.numel() - 1,
                     in_ptr=dg_in_ptr, in_idx=dg_in_idx, in_deg=dg_in_deg)
    dgs = None
    if mesh is not None:
        dgs = [dg.to(dev) for dev in mesh.axis_devices(mesh_axis)]
    met = start_a == start_b
    lane = torch.nonzero(~met).squeeze(1)
    pa, pb = start_a[lane], start_b[lane]
    for _ in range(t_max):
        if lane.numel() == 0:
            break
        r = torch.rand((4, lane.numel()), generator=gen,
                       device=dg.device)
        if dgs is None:
            go, pa, pb, hit = _advance(dg, pa, pb, r, sqrt_c)
        else:
            go, pa, pb, hit = _advance_split(dgs, mesh, mesh_axis, pa, pb,
                                             r, sqrt_c)
        met[lane] = hit     # live lanes have not met yet
        # one host sync per step: keep the pairs still walking apart
        live = torch.nonzero(go & ~hit).squeeze(1)
        lane, pa, pb = lane[live], pa[live], pb[live]
    return met


def paired_meet_chunked(dg: DeviceGraph, start_a, start_b,
                        gen: torch.Generator, sqrt_c: float, t_max: int,
                        chunk: int = DEFAULT_CHUNK, mesh=None,
                        mesh_axis: str = "data") -> np.ndarray:
    """Host-driven loop over :func:`paired_meet` in chunks of ``chunk``
    pairs (the starts are host arrays; each chunk goes to ``dg``'s
    device and its indicators come back): bool (W,) NumPy. The
    reference pads each chunk to a compile bucket; eager torch needs no
    bucket, so a chunk runs at its own size."""
    start_a, start_b = np.asarray(start_a), np.asarray(start_b)
    out = np.zeros(len(start_a), dtype=bool)
    for lo in range(0, len(start_a), chunk):
        sa, sb = (torch.as_tensor(x[lo:lo + chunk].astype(np.int64),
                                  device=dg.device)
                  for x in (start_a, start_b))
        out[lo:lo + chunk] = paired_meet(
            dg.in_ptr, dg.in_idx, dg.in_deg, sa, sb, gen, sqrt_c, t_max,
            mesh=mesh, mesh_axis=mesh_axis).cpu().numpy()
    return out


def walk_positions(dg_in_ptr, dg_in_idx, dg_in_deg, starts,
                   gen: torch.Generator, sqrt_c: float,
                   t_max: int) -> torch.Tensor:
    """Full trajectories over a :class:`DeviceGraph`'s arrays: (W,
    t_max+1) int32 positions, -1 from the step at which a walk stops on.
    A test oracle for hitting probabilities. Every lane draws two
    uniforms a step (continue, in-edge), stopped or not, on ``gen``'s
    device, which must be the arrays'."""
    pos = torch.as_tensor(starts, device=dg_in_ptr.device).long()
    alive = torch.ones_like(pos, dtype=torch.bool)
    traj = torch.empty((len(pos), t_max + 1), dtype=torch.int32,
                       device=pos.device)
    traj[:, 0] = pos
    last = dg_in_idx.numel() - 1
    for t in range(1, t_max + 1):
        r = torch.rand((2, len(pos)), generator=gen, device=pos.device)
        deg = dg_in_deg[pos]
        ok = alive & (r[0] < sqrt_c) & (deg > 0)
        off = torch.minimum((r[1] * deg).long(), deg - 1).clamp_(min=0)
        nxt = dg_in_idx[(dg_in_ptr[pos] + off).clamp_(0, last)]
        pos = torch.where(ok, nxt, pos)
        alive = ok
        traj[:, t] = torch.where(ok, pos, -1)
    return traj


def estimate_simrank_by_walks(g: csr.Graph, u: int, v: int, c: float,
                              n_walks: int, seed: int = 0,
                              t_max: int | None = None, *,
                              device=None) -> float:
    """Direct Lemma-3 estimator on ``device`` (``cuda`` unless
    ``device="cpu"``): the fraction of ``n_walks`` walk pairs from (u, v)
    that meet. O(n_walks / eps^2) -- a test oracle."""
    dev = resolve_device(device)
    dg = DeviceGraph.from_graph(g, device=dev)
    sc = math.sqrt(c)
    t_max = t_max or default_t_max(sc)
    gen = torch.Generator(device=dev).manual_seed(seed)
    met = paired_meet_chunked(dg, np.full(n_walks, u), np.full(n_walks, v),
                              gen, sc, t_max)
    return float(met.mean())
