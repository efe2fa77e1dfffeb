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


def class_gaussian_score(sde: SDE, mus, s0: float = 0.5, null_mu: float = 0.3):
    """Label-aware exact score (DESIGN.md §9): label ``y`` has data
    x0 ~ N(mus[y], s0² I); a negative (null) label, and ``y=None``, select
    ``null_mu`` with exactly ``gaussian_score(sde, null_mu, s0)``'s
    arithmetic, so classifier-free guidance at scale 0 is bitwise the
    unconditional solve."""
    mus = torch.as_tensor(mus, dtype=torch.float32)

    def score(x: Tensor, t: Tensor, y: Tensor | None = None) -> Tensor:
        m, std = sde.marginal(t)
        m, std = bcast(m, x), bcast(std, x)
        if y is None:
            mu_y = torch.full((x.shape[0],), null_mu, dtype=torch.float32,
                              device=x.device)
        else:
            table = mus.to(x.device)
            picked = table[torch.clamp(y, 0, table.shape[0] - 1).long()]
            mu_y = torch.where(y < 0, torch.tensor(null_mu, dtype=torch.float32,
                                                   device=x.device), picked)
        return -(x - m * bcast(mu_y, x)) / (m * m * s0 * s0 + std * std)

    return score


def class_gaussian_noise_pred(sde: SDE, mus, s0: float = 0.5, null_mu: float = 0.3):
    """``class_gaussian_score`` as a label-aware noise prediction
    ``forward_fn(x, t, y=None)`` (score = −out/std), the analytic
    stand-in for a returns-conditioned score network."""
    score = class_gaussian_score(sde, mus, s0, null_mu)

    def forward_fn(x: Tensor, t: Tensor, y: Tensor | None = None) -> Tensor:
        _, std = sde.marginal(t)
        return -score(x, t, y) * bcast(std, x)

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
