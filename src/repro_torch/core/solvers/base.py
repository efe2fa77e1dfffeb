"""Common solver API; port of ``repro/core/solvers/base.py``.

A solver consumes an SDE, a score function s(x, t) (t a per-sample
vector), an initial state drawn from the prior and a generator, and
returns a ``SolveResult``. Only ``adaptive`` is registered in the port
so far.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class SolveResult:
    """Output of a solver run.

    x: final samples (B, ...). nfe: per-sample score evaluations (B,).
    iterations: solver loop iterations in which some sample was active
    (0-d). accepted / rejected: per-sample step counts (B,).
    """

    x: Tensor
    nfe: Tensor
    iterations: Tensor
    accepted: Tensor
    rejected: Tensor

    @property
    def mean_nfe(self) -> Tensor:
        return self.nfe.to(torch.float32).mean()

    @property
    def max_nfe(self) -> Tensor:
        return self.nfe.max()


_REGISTRY: Dict[str, Callable[..., Any]] = {}
#: solver name → score evaluations per loop iteration (int or callable
#: over the solver's keyword arguments), as in the reference
_NFE_PER_ITER: Dict[str, Any] = {}


def register_solver(name: str, *, nfe_per_iter: Any = None):
    def deco(fn):
        _REGISTRY[name] = fn
        if nfe_per_iter is not None:
            _NFE_PER_ITER[name] = nfe_per_iter
        return fn

    return deco


def solver_nfe_per_iteration(name: str, **solver_kwargs) -> int:
    """Score evaluations one loop iteration of ``name`` issues; raises
    ``ValueError`` for unknown solvers and solvers without a rule."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown solver '{name}'; available: {sorted(_REGISTRY)}")
    try:
        rule = _NFE_PER_ITER[name]
    except KeyError:
        raise ValueError(f"solver '{name}' declared no per-iteration NFE rule") from None
    return int(rule(**solver_kwargs)) if callable(rule) else int(rule)


def get_solver(name: str) -> Callable[..., Any]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver '{name}'; available: {sorted(_REGISTRY)}") from None
