"""Meshes for the launchers; port of ``repro/launch/mesh.py``.

``make_host_mesh`` is the counterpart of the reference's degenerate 1×1
mesh for smoke runs of the sharded code path: a ``("data", "model")``
mesh of one rank, over a process group that the caller has initialised
with a world of one.

``make_production_mesh`` is the reference's (16, 16) ``("data",
"model")`` mesh, or (2, 16, 16) with ``"pod"`` in front, as one rank's
place in it: a ``Mesh`` without a ``DeviceMesh`` (no process group, no
cards). The dry runs count that rank on meta tensors inside
``parallel.collectives.counting()``; outside that count a collective on
it raises. A job of the port that runs is as many ranks as it has cards,
and ``repro_torch.parallel.init_mesh(data, model, device=..., pod=...)``
lays them out.
"""

from __future__ import annotations

import torch

from repro_torch.parallel.mesh import Mesh, init_mesh


def make_production_mesh(multi_pod: bool = False, coordinate=None) -> Mesh:
    """The reference's production mesh (:13-16) as the rank at
    ``coordinate`` (default: the first), on the meta device."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    coordinate = tuple(coordinate) if coordinate is not None else (0,) * len(sizes)
    return Mesh(names, sizes, coordinate, device=torch.device("meta"))


def make_host_mesh(*, device) -> Mesh:
    """A 1×1 ``("data", "model")`` mesh over an initialised world of one,
    computing on ``device``."""
    return init_mesh(1, 1, device=device)
