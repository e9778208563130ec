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
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.graph import csr

# pairs per walk dispatch (lanes of one chunk)
DEFAULT_CHUNK = 1 << 23


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident in-CSR used by the walks."""
    n: int
    m: int
    in_ptr: torch.Tensor   # (n+1,) int64
    in_idx: torch.Tensor   # (m+1,) int64, last slot is padding
    in_deg: torch.Tensor   # (n,) int64

    @staticmethod
    def from_graph(g: csr.Graph, device) -> "DeviceGraph":
        # one pad slot: a degree-0 node's pointer may equal m
        in_idx = torch.zeros(g.m + 1, dtype=torch.int64)
        in_idx[:g.m] = torch.from_numpy(g.in_idx.astype("int64"))
        ptr = torch.from_numpy(g.in_ptr.astype("int64"))
        return DeviceGraph(n=g.n, m=g.m, in_ptr=ptr.to(device),
                           in_idx=in_idx.to(device),
                           in_deg=(ptr[1:] - ptr[:-1]).to(device))

    @property
    def device(self) -> torch.device:
        return self.in_ptr.device


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


def paired_meet(dg: DeviceGraph, start_a: torch.Tensor,
                start_b: torch.Tensor, gen: torch.Generator,
                sqrt_c: float, t_max: int) -> torch.Tensor:
    """Run paired sqrt(c)-walks; bool (W,) of the pairs that ever meet.

    A pair meets at step l >= 0 if both walks are alive and co-located;
    pairs with start_a == start_b meet at step 0 (callers that follow
    Alg 1 filter those out themselves).
    """
    met = start_a == start_b
    lane = torch.nonzero(~met).squeeze(1)
    pa, pb = start_a[lane], start_b[lane]
    for _ in range(t_max):
        if lane.numel() == 0:
            break
        r = torch.rand((4, lane.numel()), generator=gen,
                       device=dg.device)
        go = ((r[0] < sqrt_c) & (dg.in_deg[pa] > 0)
              & (r[2] < sqrt_c) & (dg.in_deg[pb] > 0))
        pa = uniform_in_neighbor(dg, pa, r[1])
        pb = uniform_in_neighbor(dg, pb, r[3])
        hit = go & (pa == pb)
        met[lane] = hit     # live lanes have not met yet
        # one host sync per step: keep the pairs still walking apart
        live = torch.nonzero(go & ~hit).squeeze(1)
        lane, pa, pb = lane[live], pa[live], pb[live]
    return met
