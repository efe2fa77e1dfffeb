"""DDIM (Song et al. 2020b), the deterministic VP-only fast baseline; port
of ``repro/core/solvers/ddim.py``.

Defined only for VP diffusions (paper Sec. 4). With ᾱ(t) = m(t)² of the
continuous VP marginal, the score gives the noise prediction
ε̂ = −√(1 − ᾱ)·s(x, t), and the η = 0 update is

  x_{t'} = √ᾱ'·x̂₀ + √(1 − ᾱ')·ε̂,   x̂₀ = (x − √(1 − ᾱ)·ε̂)/√ᾱ.

The update has no noise term, so it is not K5's form and stays plain
torch, as it is plain jnp in the reference. The grid is the reference's
fp32 ``linspace`` bit for bit. ``eta`` is accepted and, as in the
reference, not used.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.sde import VPSDE, bcast
from repro_torch.core.solvers.base import (
    SolveResult, fixed_grid_result, local_state, register_solver, tweedie_tail,
)
from repro_torch.core.solvers.predictor_corrector import linspace_f32
from repro_torch.device import resolve_device

Tensor = torch.Tensor


@register_solver("ddim", nfe_per_iter=1)
def ddim(sde: VPSDE, score_fn: Callable, x_init: Tensor,
         generator: torch.Generator | None = None, *, n_steps: int = 100,
         eta: float = 0.0, denoise: bool = True,
         noise_fn: Callable | None = None, device="cuda",
         sharding=None) -> SolveResult:
    """``n_steps`` deterministic DDIM steps on ``device``; draws nothing
    (``generator`` and ``noise_fn`` are accepted for a uniform API).
    Under a mesh (``sharding``) the rank steps its rows."""
    if not isinstance(sde, VPSDE):
        raise TypeError("DDIM is defined only for VP diffusions (paper Sec. 4)")
    del generator, noise_fn, eta
    dev = resolve_device(device)
    x = local_state(x_init, dev, sharding)
    batch = x.shape[0]
    grid = linspace_f32(sde.T, sde.t_eps, n_steps + 1, dev)
    grid = grid[:, None].expand(n_steps + 1, batch).contiguous()

    def alpha_bar(t):
        m, _ = sde.marginal(t)
        return bcast(m * m, x)

    with torch.no_grad():
        for i in range(n_steps):
            t = grid[i]
            ab, ab_n = alpha_bar(t), alpha_bar(grid[i + 1])
            score = score_fn(x, t)
            eps_hat = -torch.sqrt(1.0 - ab) * score
            x0_hat = (x - torch.sqrt(1.0 - ab) * eps_hat) / torch.sqrt(ab)
            x = (torch.sqrt(ab_n) * x0_hat
                 + torch.sqrt(torch.clamp(1.0 - ab_n, min=0.0)) * eps_hat)
        res = fixed_grid_result(x, n_steps, 1)
        if denoise:
            res.x = tweedie_tail(sde, score_fn, x)
            res.nfe = res.nfe + 1
    return res
