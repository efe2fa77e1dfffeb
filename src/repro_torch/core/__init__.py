"""Port of ``repro/core``: SDEs, tolerances, precision, the solvers, the
DSM loss and the sampling entry points."""

from repro_torch.core.losses import dsm_loss, make_loss_fn
from repro_torch.core.sampling import sample, sample_chunked, solve_in_chunks
from repro_torch.core.sde import SDE, SubVPSDE, VESDE, VPSDE, get_sde
from repro_torch.core.solvers import (
    ForwardAdaptiveConfig, SolveResult, adaptive_forward, available_solvers, get_solver,
)
from repro_torch.core.solvers.adaptive import AdaptiveConfig

__all__ = [
    "AdaptiveConfig", "ForwardAdaptiveConfig", "SDE", "SolveResult", "SubVPSDE",
    "VESDE", "VPSDE", "adaptive_forward", "available_solvers", "dsm_loss", "get_sde",
    "get_solver", "make_loss_fn", "sample", "sample_chunked", "solve_in_chunks",
]
