"""Which dimension of each SLING array is split over a mesh axis.

Port of the SLING half of ``repro/launch/sharding.py``
(``sling_index_specs``, ``sling_build_specs``); the model parameter
rules belong to the model stack. Where the reference gives a
``PartitionSpec``, the port gives ``(axis, dim)``: dimension ``dim`` is
cut into ``mesh.shape[axis]`` contiguous pieces, piece s on
``mesh.axis_devices(axis)[s]``; ``None`` means replicated on every one
of those devices. One table, so that ``shard_query.shard_index`` and the
fan-out that reads its slabs, and the build and walk splits, cannot
drift apart. :func:`place` applies a spec.
"""
from __future__ import annotations

import torch


def sling_index_specs(axis: str = "data") -> dict:
    """The node-sharded serving state (``core/shard_query.py``): the
    packed HP rows, d and the dst-partitioned edges split their leading
    node (or shard) dimension; query ids are replicated."""
    row = (axis, 0)
    return {
        "keys": row,        # (n_pad, width_cap) packed H rows
        "vals": row,
        "d": row,           # (n_pad,) correction factors
        "edges": row,       # dst-partitioned edges, a slab layout a shard
        "queries": None,    # (B,) query ids: replicated
    }


def sling_build_specs(axis: str = "data") -> dict:
    """The mesh-parallel build (``hp_index.shard_build_hp``,
    ``walks.paired_meet``): a superblock of S * block seed columns
    splits its column dimension, so shard s propagates the block the
    single-device build would; walk batches split their one dimension.
    The graph, which every shard reads whole, is copied to each device
    as it is; the reference's "replicated" entry is left out, since
    nothing reads it."""
    return {
        "seeds": (axis, 1),     # (n, S * block) one-hot columns
        "walks": (axis, 0),     # (pairs,) live walk lanes
    }


def place(x: torch.Tensor, spec, mesh, axis: str | None = None) -> list:
    """The pieces of ``x`` under ``spec`` on their devices, in shard
    order: contiguous pieces along the spec's dimension, or, for a
    replicated spec, ``x`` itself on each device along ``axis``. A piece
    already on its device is not copied; copies are ``non_blocking``."""
    if spec is None:
        return [x.to(dev, non_blocking=True)
                for dev in mesh.axis_devices(axis)]
    ax, dim = spec
    devs = mesh.axis_devices(ax)
    return [p.to(dev, non_blocking=True) for p, dev in
            zip(torch.tensor_split(x, len(devs), dim=dim), devs)]
