"""Device meshes for the single-controller sharded paths.

Port of ``repro/launch/mesh.py`` (the debug mesh; the TPU pod meshes
are the model stack's, not SimRank's). The reference drives a
``jax.sharding.Mesh`` from one process through ``shard_map``; the port
keeps that contract with no process per shard: a :class:`Mesh` names
its axes, maps each to a size (``mesh.shape[axis]``, as JAX's does) and
holds one ``torch.device`` per position. A shard is a slab of tensors
on its position's device, and the sharded paths run the shards in
order from the calling thread (``core/shard_query.py``).

A mesh may repeat a device: ``make_debug_mesh((4,), ("data",),
devices=["cpu"] * 4)`` is the port's counterpart of the reference's
forced host devices, and four shards on ``cuda:0`` run every sharded
path on one card.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import canonical, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a grid of devices, row-major (the last axis
    varies fastest, as in JAX)."""
    axis_names: tuple[str, ...]
    dims: tuple[int, ...]
    flat: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} do not fit "
                             f"shape {self.dims}")
        if any(d < 1 for d in self.dims) or \
                math.prod(self.dims) != len(self.flat):
            raise ValueError(f"mesh shape {self.dims} needs "
                             f"{math.prod(self.dims)} devices, got "
                             f"{len(self.flat)}")

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size} in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def devices(self) -> np.ndarray:
        """The devices as an object array of the mesh's shape."""
        grid = np.empty(len(self.flat), dtype=object)
        grid[:] = list(self.flat)
        return grid.reshape(self.dims)

    def axis_devices(self, axis: str, **coords: int
                     ) -> tuple[torch.device, ...]:
        """The devices along ``axis``, the other axes at ``coords``
        (0 where not given): where a tensor split over ``axis`` puts its
        pieces."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: "
                             f"{self.axis_names}")
        at = [coords.get(a, 0) for a in self.axis_names]
        out = []
        for i in range(self.shape[axis]):
            at[self.axis_names.index(axis)] = i
            out.append(self.devices[tuple(at)])
        return tuple(out)


def mesh_device(mesh, axis: str, device=None) -> torch.device:
    """Where a sharded entry point lands its results: the first device
    along ``axis``. ``device``, when a caller gives one, must name it."""
    home = mesh.axis_devices(axis)[0]
    if device is not None and canonical(resolve_device(device)) != home:
        raise ValueError(f"device={device}, but a call sharded over "
                         f"'{axis}' runs from the axis's first device "
                         f"{home}")
    return home


def _devices(count: int, devices) -> tuple[torch.device, ...]:
    if devices is None:
        have = torch.cuda.device_count()
        if have < count:
            raise RuntimeError(
                f"mesh needs {count} CUDA devices, found {have}; pass "
                "devices= (a device may repeat, e.g. ['cpu'] * 4)")
        return tuple(torch.device("cuda", i) for i in range(count))
    devs = tuple(canonical(d) for d in devices)
    if len(devs) != count:
        raise ValueError(f"mesh needs {count} devices, got {len(devs)}")
    return devs


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    devices=None) -> Mesh:
    """A small mesh: by default over the first prod(shape) CUDA devices
    (raises if there are fewer), or over ``devices`` in row-major
    order, which may repeat a device."""
    shape = tuple(int(s) for s in shape)
    return Mesh(axis_names=tuple(axes), dims=shape,
                flat=_devices(math.prod(shape), devices))
