"""Port of ``repro/core/solvers``; importing it registers ``adaptive``."""

from repro_torch.core.solvers import adaptive as _adaptive  # noqa: F401  (registers)
from repro_torch.core.solvers.base import (  # noqa: F401
    SolveResult, get_solver, register_solver, solver_nfe_per_iteration,
)
