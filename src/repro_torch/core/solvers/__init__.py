"""Port of ``repro/core/solvers``: the paper's adaptive solver and the
baselines it is compared with. Importing the package registers
``adaptive``, ``momentum``, ``heun``, ``em``, ``pc``, ``pc_hmc``, ``ddim``
and ``ode``."""

from repro_torch.core.solvers import adaptive as _adaptive  # noqa: F401  (registers)
from repro_torch.core.solvers import ddim as _ddim  # noqa: F401
from repro_torch.core.solvers import euler_maruyama as _em  # noqa: F401
from repro_torch.core.solvers import heun as _heun  # noqa: F401
from repro_torch.core.solvers import momentum as _momentum  # noqa: F401
from repro_torch.core.solvers import predictor_corrector as _pc  # noqa: F401
from repro_torch.core.solvers import probability_flow as _ode  # noqa: F401
from repro_torch.core.solvers.adaptive import (  # noqa: F401
    ForwardAdaptiveConfig, adaptive_forward, events_pending, solve_horizons,
)
from repro_torch.core.solvers.base import (  # noqa: F401
    SlotStreams, SolveResult, available_solvers, get_solver, register_solver,
    solver_nfe_per_iteration,
)
