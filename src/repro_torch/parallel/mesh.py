"""The port's device mesh (no reference module of this name: the reference
uses ``jax.sharding.Mesh``, built in ``repro/launch/mesh.py``).

A ``Mesh`` names the axes of a ``torch.distributed`` job the way the
reference names its mesh axes: ``"pod"`` and ``"data"`` carry the batch,
``"model"`` the features. It knows the size of every axis
(``mesh.shape[axis]``, as the reference's ``mesh.shape[...]``), this
rank's coordinate on each, and, through the
``torch.distributed.device_mesh.DeviceMesh`` it wraps, the process group
of each axis. ``init_mesh`` builds one from an initialised process group.

A ``Mesh`` without a ``DeviceMesh`` describes one rank's place in a
layout and nothing more: the sharding rules are pure functions of sizes
and coordinates, and such a mesh lets them be read without a process
group. It has no process groups, so any collective on it raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names, sizes and this rank's coordinate; optionally the
    ``DeviceMesh`` whose groups the collectives use."""

    axis_names: tuple
    sizes: tuple
    coordinate: tuple
    device: torch.device = torch.device("cpu")
    device_mesh: Optional[object] = None

    def __post_init__(self):
        if not len(self.axis_names) == len(self.sizes) == len(self.coordinate):
            raise ValueError("axis_names, sizes and coordinate differ in length")
        for name, size, c in zip(self.axis_names, self.sizes, self.coordinate):
            if name not in AXES:
                raise ValueError(f"unknown mesh axis {name!r} (want one of {AXES})")
            if not 0 <= c < size:
                raise ValueError(f"coordinate {c} outside axis {name!r} of size {size}")

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coord(self, axis: str) -> int:
        return self.coordinate[self.axis_names.index(axis)]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's shard index over ``axes``, major to minor (the order
        of a ``PartitionSpec`` tuple)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord(a)
        return i

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` (``None``: the whole mesh).
        Raises on a mesh without a ``DeviceMesh``."""
        if self.device_mesh is None:
            raise RuntimeError("this Mesh has no process groups (it was built "
                               "without a DeviceMesh); use init_mesh")
        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def key(self) -> tuple:
        """The mesh's identity where a cached CUDA graph is keyed on it: the
        axes, sizes, this rank's coordinate, and the whole mesh's process
        group (by identity) and backend. Raises on a mesh without a
        ``DeviceMesh``."""
        group = self.group()
        return (self.axis_names, self.sizes, self.coordinate, id(group),
                dist.get_backend(group))

    def ranks(self) -> list:
        """Global rank at each mesh position, as a nested list shaped like
        the mesh."""
        if self.device_mesh is None:
            raise RuntimeError("this Mesh has no process groups; use init_mesh")
        return self.device_mesh.mesh.tolist()


def init_mesh(data: int, model: int = 1, *, device, pod: Optional[int] = None) -> Mesh:
    """A ``("data", "model")`` mesh over the initialised default process
    group, whose world size must be ``data · model``; with ``pod``, the
    reference's ``("pod", "data", "model")`` layout (``repro/launch/
    mesh.py:13-16``) over a world of ``pod · data · model``.

    ``device`` is the device this rank computes on (``cuda:i`` or
    ``cpu``). Ranks are laid out row-major: rank r sits at
    (r // model, r % model), and with ``pod`` at
    (r // (data · model), (r // model) % data, r % model). Raises when no
    process group is initialised; there is no single-process stand-in.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("init_mesh needs an initialised torch.distributed "
                           "process group (init_process_group first)")
    names, sizes = ("data", "model"), (data, model)
    if pod is not None:
        names, sizes = ("pod",) + names, (pod,) + sizes
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {sizes} does not cover the world of {world} ranks")
    device = torch.device(device)
    dm = init_device_mesh(device.type, sizes, mesh_dim_names=names)
    return Mesh(names, sizes, tuple(dm.get_coordinate()), device=device, device_mesh=dm)
