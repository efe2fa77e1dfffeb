"""Port of ``repro/parallel``: the device mesh, the sharding rules and the
collectives of data-parallel adaptive sampling and serving over
``torch.distributed``.

``Mesh`` and ``init_mesh`` (``parallel/mesh.py``) stand in for
``jax.sharding.Mesh``; ``sharding.py`` says which rows of each leaf a
rank owns; ``collectives.py`` holds the O(B) error combine, the O(1)
loop-control reduction, the row gather and the serve loop's gathers of
bookkeeping and retired rows. The reference's ``pipeline.py`` and its
tensor-parallel rules are not ported yet (ROADMAP A11, the LM half).
"""

from repro_torch.parallel.mesh import Mesh, init_mesh
from repro_torch.parallel.sharding import (
    RowSharding,
    batch_sharding,
    data_axes,
    replicated,
    sample_state_shardings,
    serving_loop_shardings,
    solver_carry_shardings,
)

__all__ = [
    "Mesh", "RowSharding", "batch_sharding", "data_axes", "init_mesh",
    "replicated", "sample_state_shardings", "serving_loop_shardings",
    "solver_carry_shardings",
]
