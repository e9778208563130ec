"""Device meshes for the single-controller sharded paths.

Port of ``repro/launch/mesh.py``: the production meshes and the debug
mesh. The reference drives a ``jax.sharding.Mesh`` from one process
through ``shard_map``; the port keeps that contract with no process per
shard: a :class:`Mesh` names its axes, maps each to a size
(``mesh.shape[axis]``, as JAX's does) and holds one ``torch.device``
per position. A shard is a slab of tensors on its position's device,
and the sharded paths run the shards in order from the calling thread
(``core/shard_query.py``, ``models/gnn_sharded.py``, ``models/moe.py``).

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
        return self.axes_devices((axis,), **coords)

    def axes_positions(self, axes, **coords: int) -> list[tuple[int, ...]]:
        """The positions over the product of ``axes``, row-major in the
        order given (the first axis varies slowest), the other axes at
        ``coords`` (0 where not given): shard s of a dimension split
        over ``axes`` (a ``shard_map`` spec ``P(axes)``) is item s."""
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r}: "
                                 f"{self.axis_names}")
        at = [coords.get(a, 0) for a in self.axis_names]
        out = []
        for idx in np.ndindex(*(self.shape[a] for a in axes)):
            for a, i in zip(axes, idx):
                at[self.axis_names.index(a)] = i
            out.append(tuple(at))
        return out

    def axes_devices(self, axes, **coords: int) -> tuple[torch.device, ...]:
        """The devices at :meth:`axes_positions`: where the shards of a
        dimension split over several axes run (``()`` gives the one
        device at ``coords``)."""
        grid = self.devices
        return tuple(grid[p] for p in self.axes_positions(axes, **coords))


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


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``; over
    the first 256 or 512 CUDA devices (raises if there are fewer), or
    over ``devices``, which may repeat a device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_debug_mesh(shape, axes, devices=devices)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    devices=None) -> Mesh:
    """A small mesh: by default over the first prod(shape) CUDA devices
    (raises if there are fewer), or over ``devices`` in row-major
    order, which may repeat a device."""
    shape = tuple(int(s) for s in shape)
    return Mesh(axis_names=tuple(axes), dims=shape,
                flat=_devices(math.prod(shape), devices))
