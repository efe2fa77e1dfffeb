"""Adaptive Heun solver for the probability-flow ODE (DESIGN.md §11);
port of ``repro/core/solvers/heun.py``.

With ``AdaptiveConfig.probability_flow`` the Algorithm-1 body integrates
dx = [f − ½g²s] dt: the score coefficients halve, the noise vanishes and
the main draw is skipped, so the paper's extrapolated pair becomes Heun's
trapezoid with an embedded Euler error estimate, at per-sample step
sizes. Unlike the batch-global RK45 ``ode`` baseline it keeps the whole
``SolverCarry`` contract, so it chunks, compacts, conditions and serves
like the adaptive SDE solver. Its noise source feeds only a projecting
conditioner's draw: a ``SlotStreams`` counter moves once an iteration
with one and not at all without.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.sde import SDE
from repro_torch.core.solvers.adaptive import AdaptiveConfig, adaptive, resolve_config
from repro_torch.core.solvers.base import SolveResult, register_solver


def heun_config(config: Optional[AdaptiveConfig] = None, **overrides) -> AdaptiveConfig:
    """The resolved config with ``probability_flow`` forced on."""
    return dataclasses.replace(resolve_config(config, overrides), probability_flow=True)


@register_solver("heun", nfe_per_iter=2)
def heun(sde: SDE, score_fn: Callable, x_init: torch.Tensor, generator=None, *,
         config: Optional[AdaptiveConfig] = None, sharding=None,
         **kwargs) -> SolveResult:
    """Adaptive second-order probability-flow solve: takes everything
    ``adaptive`` takes; ``probability_flow`` is forced on. ``sharding`` (from
    ``sample(mesh=)``) goes to ``adaptive``: the solve is data-parallel."""
    overrides = {k: kwargs.pop(k) for k in list(kwargs)
                 if k in AdaptiveConfig.__dataclass_fields__}
    return adaptive(sde, score_fn, x_init, generator,
                    config=heun_config(config, **overrides), sharding=sharding,
                    **kwargs)
