"""Adaptive heavy-ball momentum sampler (DESIGN.md §11); port of
``repro/core/solvers/momentum.py``.

Each proposal of Algorithm 1 gains β·v, v = x − x_prev the last accepted
displacement. The transport is shared by both embedded proposals (x' and
x̃), so the fp32 error controller still measures the EM / Improved-Euler
gap and keeps its per-sample steps; the analytic W2 gate judges the bias
(``analysis.solver_select.ZOO``). It is not a loop of its own: it is the
Algorithm-1 body with ``AdaptiveConfig.momentum`` set, so it rides every
seam of ``adaptive`` (chunks, per-slot streams, compaction, the fused
step K1, conditioners, the device-resident driver). x_prev doubles as the
momentum buffer: v = 0 at ``init_carry`` and at a server's admission,
where x_prev = x = the prior.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.sde import SDE
from repro_torch.core.solvers.adaptive import AdaptiveConfig, adaptive, resolve_config
from repro_torch.core.solvers.base import SolveResult, register_solver

#: the family's β when the config leaves ``momentum`` at 0: cuts NFE below
#: the plain solver's at equal tolerance and holds the W2 gate
DEFAULT_BETA = 0.15


def momentum_config(config: Optional[AdaptiveConfig] = None, **overrides) -> AdaptiveConfig:
    """The resolved config with ``DEFAULT_BETA`` where ``momentum`` is 0.0."""
    cfg = resolve_config(config, overrides)
    return cfg if cfg.momentum != 0.0 else dataclasses.replace(cfg, momentum=DEFAULT_BETA)


@register_solver("momentum", nfe_per_iter=2)
def momentum(sde: SDE, score_fn: Callable, x_init: torch.Tensor, generator=None, *,
             config: Optional[AdaptiveConfig] = None, sharding=None,
             **kwargs) -> SolveResult:
    """Heavy-ball Algorithm 1: takes everything ``adaptive`` takes; β is the
    config's ``momentum``, ``DEFAULT_BETA`` where that is 0.0. ``sharding`` (from
    ``sample(mesh=)``) goes to ``adaptive``: the solve is data-parallel."""
    overrides = {k: kwargs.pop(k) for k in list(kwargs)
                 if k in AdaptiveConfig.__dataclass_fields__}
    return adaptive(sde, score_fn, x_init, generator,
                    config=momentum_config(config, **overrides), sharding=sharding,
                    **kwargs)
