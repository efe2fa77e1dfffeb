"""DDIM (Song et al. 2020b), the deterministic VP-only fast baseline; port
of ``repro/core/solvers/ddim.py``.

Defined only for VP diffusions (paper Sec. 4). With ᾱ(t) = m(t)² of the
continuous VP marginal, the score gives the noise prediction
ε̂ = −√(1 − ᾱ)·s(x, t), and the η = 0 update is

  x_{t'} = √ᾱ'·x̂₀ + √(1 − ᾱ')·ε̂,   x̂₀ = (x − √(1 − ᾱ)·ε̂)/√ᾱ.

The update has no noise term, so it is not K5's form and stays plain
torch, as it is plain jnp in the reference. The grid is the reference's
fp32 ``linspace`` bit for bit (``grid.linspace_point``). ``eta`` is
accepted and, as in the reference, not used.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.sde import VPSDE, bcast
from repro_torch.core.solvers import grid
from repro_torch.core.solvers.adaptive import graphable
from repro_torch.core.solvers.base import (
    SolveResult, fixed_grid_result, local_state, register_solver, tweedie_tail,
)
from repro_torch.device import resolve_device

Tensor = torch.Tensor


@register_solver("ddim", nfe_per_iter=1)
def ddim(sde: VPSDE, score_fn: Callable, x_init: Tensor, generator=None, *,
         n_steps: int = 100, eta: float = 0.0, denoise: bool = True,
         noise_fn: Callable | None = None, device="cuda",
         sharding=None) -> SolveResult:
    """``n_steps`` deterministic DDIM steps on ``device``; draws nothing
    (``generator`` and ``noise_fn`` are accepted for a uniform API).
    Under a mesh (``sharding``) the rank steps its rows. With no
    ``noise_fn`` (under a mesh on the card, an NCCL mesh: ``graphable``)
    the grid runs as one captured CUDA graph (``grid.run_grid``), bitwise
    the host-driven loop."""
    if not isinstance(sde, VPSDE):
        raise TypeError("DDIM is defined only for VP diffusions (paper Sec. 4)")
    del eta
    dev = resolve_device(device)
    x = local_state(x_init, dev, sharding)
    batch = x.shape[0]

    def alpha_bar(t, like):
        m, _ = sde.marginal(t)
        return bcast(m * m, like)

    def make_step(score):
        a, b = grid.ends(sde)

        def step(c: grid.GridCarry) -> grid.GridCarry:
            i = c.iterations
            t = grid.linspace_point(c, i, a, b).expand(batch).contiguous()
            t_next = grid.linspace_point(c, i + 1, a, b).expand(batch).contiguous()
            x = c.x
            ab, ab_n = alpha_bar(t, x), alpha_bar(t_next, x)
            eps_hat = -torch.sqrt(1.0 - ab) * score(x, t)
            x0_hat = (x - torch.sqrt(1.0 - ab) * eps_hat) / torch.sqrt(ab)
            x = (torch.sqrt(ab_n) * x0_hat
                 + torch.sqrt(torch.clamp(1.0 - ab_n, min=0.0)) * eps_hat)
            return grid.advance(c, x, 0)

        return step

    carry = grid.init_grid(sde, x, n_steps)
    carry = grid.run_grid("ddim", sde, score_fn, carry, n_steps, make_step,
                          graphed=graphable(generator, noise_fn, sharding, draws=False),
                          sharding=sharding)
    with torch.no_grad():
        res = fixed_grid_result(carry.x, n_steps, 1)
        if denoise:
            res.x = tweedie_tail(sde, score_fn, carry.x)
            res.nfe = res.nfe + 1
    return res
