"""Port of ``repro/parallel``: the device mesh, the sharding rules and the
collectives over ``torch.distributed``.

``Mesh`` and ``init_mesh`` (``parallel/mesh.py``) stand in for
``jax.sharding.Mesh``; ``sharding.py`` holds the rows of each leaf a rank
owns in data-parallel sampling and serving, and the language models'
rules (``param_shardings``, ``kv_cache_spec``, ``kv_cache_sharding``):
which block of each parameter and decode cache a rank holds under a
``("data", "model")`` mesh, ZeRO-3's data-axis blocks too;
``collectives.py`` the O(B) error combine, the O(1) loop-control
reduction, the row and bookkeeping gathers of sampling and serving, the
LM's model-axis sums and gathers and ``flash_decode``, their backward
passes (the autograd pair: ``all_reduce_sum`` and
``enter_model_region``), and training's data-axis collectives,
the pipeline's stage handoffs, and the dry runs' counting mode;
``pipeline.py`` the GPipe forward over a mesh axis (``pipeline_forward``,
``stage_layers``).
"""

from repro_torch.parallel.collectives import (
    all_gather_dim,
    all_reduce_sum,
    enter_model_region,
    flash_decode,
    fsdp_broadcast,
    fsdp_gather,
    reduce_gradients,
    reduce_scatter_dim,
    split_dim,
    zero1_gather_,
)
from repro_torch.parallel.mesh import Mesh, init_mesh
from repro_torch.parallel.pipeline import pipeline_forward, stage_layers
from repro_torch.parallel.sharding import (
    MODEL_AXIS,
    ParamSharding,
    RowSharding,
    batch_sharding,
    data_axes,
    kv_cache_sharding,
    kv_cache_spec,
    param_shardings,
    replicated,
    sample_state_shardings,
    serving_loop_shardings,
    solver_carry_shardings,
)

__all__ = [
    "MODEL_AXIS", "Mesh", "ParamSharding", "RowSharding", "all_gather_dim", "all_reduce_sum",
    "batch_sharding", "data_axes", "enter_model_region", "flash_decode", "fsdp_broadcast",
    "fsdp_gather", "init_mesh", "kv_cache_sharding", "kv_cache_spec", "param_shardings",
    "pipeline_forward", "reduce_gradients", "reduce_scatter_dim", "replicated",
    "sample_state_shardings", "serving_loop_shardings", "solver_carry_shardings", "split_dim",
    "stage_layers", "zero1_gather_",
]
