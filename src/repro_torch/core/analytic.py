"""Closed-form scores for Gaussian data; port of ``repro/core/analytic.py``.

For x0 ~ N(mu, s0² I) under a linear-drift SDE with transition kernel
N(m(t)·x0, std(t)² I) the time-t marginal is N(m(t)·mu, m(t)²·s0² +
std(t)²), so the exact score needs no network. The solver tests and the
sampling gate use these as their oracle.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.sde import SDE, bcast

Tensor = torch.Tensor


def gaussian_score(sde: SDE, mu: float = 0.3, s0: float = 0.5):
    """Exact score ∇log p_t for x0 ~ N(mu, s0² I); t is a (B,) vector."""

    def score(x: Tensor, t: Tensor) -> Tensor:
        m, std = sde.marginal(t)
        m, std = bcast(m, x), bcast(std, x)
        return -(x - m * mu) / (m * m * s0 * s0 + std * std)

    return score


def gaussian_noise_pred(sde: SDE, mu: float = 0.3, s0: float = 0.5):
    """The same score as a noise-prediction ``forward_fn(x, t)``
    (score = −out/std), the convention of the DiT score net."""
    score = gaussian_score(sde, mu, s0)

    def forward_fn(x: Tensor, t: Tensor) -> Tensor:
        _, std = sde.marginal(t)
        return -score(x, t) * bcast(std, x)

    return forward_fn


def gaussian_marginal_moments(sde: SDE, mu: float = 0.3, s0: float = 0.5,
                              t: float | None = None):
    """Exact (mean, std) of x_t for x0 ~ N(mu, s0² I); t defaults to
    ``sde.t_eps``."""
    tt = sde.t_eps if t is None else t
    m, s = sde.marginal(torch.tensor(tt, dtype=torch.float32))
    return float(m) * mu, math.sqrt(float(m) ** 2 * s0**2 + float(s) ** 2)


def gaussian_w2(mu1: float, s1: float, mu2: float, s2: float) -> float:
    """Exact 2-Wasserstein distance between 1-D Gaussians."""
    return math.sqrt((mu1 - mu2) ** 2 + (s1 - s2) ** 2)
