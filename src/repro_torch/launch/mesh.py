"""Meshes for the launchers; port of ``repro/launch/mesh.py``.

``make_host_mesh`` is the counterpart of the reference's degenerate 1×1
mesh for smoke runs of the sharded code path: a ``("data", "model")``
mesh of one rank, over a process group that the caller has initialised
with a world of one. The reference's ``make_production_mesh`` (16×16
and 2×16×16 TPU v5e meshes) has no counterpart: a job of the port is as
many ranks as it has cards, and ``repro_torch.parallel.init_mesh(data,
model, device=...)`` lays them out.
"""

from __future__ import annotations

from repro_torch.parallel.mesh import Mesh, init_mesh


def make_host_mesh(*, device) -> Mesh:
    """A 1×1 ``("data", "model")`` mesh over an initialised world of one,
    computing on ``device``."""
    return init_mesh(1, 1, device=device)
