"""Continuous-time denoising score matching (paper Eq. 3); port of
``repro/core/losses.py``.

L(θ) = E_{t ~ U[t_eps, T], x0 ~ data, xt ~ p(xt|x0)}
         [ λ(t)/2 · ‖s_θ(xt, t) − ∇_{xt} log p(xt|x0)‖² ]

with λ(t) = std(t)², which turns the inner term into the "noise
prediction" form ½‖std·s_θ + z‖².

The reference draws t and z from ``jax.random.split(key)``; the port
draws them, t first, from an explicit ``torch.Generator``. ``t=`` and
``z=`` replace the draws: tests pass the reference's own (t, z) through
them, as the solver tests pass its noise (JAX's threefry and torch's
generators never give the same numbers).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.sde import SDE

Tensor = torch.Tensor
ScoreApply = Callable[..., Tensor]  # (params, x, t) -> score


def dsm_loss(sde: SDE, apply_fn: ScoreApply, params, x0: Tensor,
             generator: Optional[torch.Generator] = None, *,
             t: Optional[Tensor] = None, z: Optional[Tensor] = None) -> Tensor:
    """Scalar DSM loss over a batch of clean samples ``x0`` (B, ...).

    ``apply_fn(params, xt, t)`` is the score; ``params`` is whatever it
    takes (an ``nn.Module``, a list of tensors). t ~ U[t_eps, T] and z ~
    N(0, I) come from ``generator`` on x0's device unless given.
    """
    batch = x0.shape[0]
    if (t is None or z is None) and generator is None:
        raise ValueError("dsm_loss needs a generator unless both t and z are given")
    if t is None:
        u = torch.rand(batch, generator=generator, dtype=torch.float32,
                       device=x0.device)
        t = sde.t_eps + u * (sde.T - sde.t_eps)
    if z is None:
        z = torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                        device=x0.device)
    xt = sde.perturb(x0, t, z)
    score = apply_fn(params, xt, t)
    _, std = sde.marginal(t)
    std = std.reshape((-1,) + (1,) * (x0.ndim - 1))
    # λ(t)=std² ⇒ λ/2‖s − (−z/std)‖² = ½‖std·s + z‖²
    per_sample = 0.5 * torch.sum((std * score + z) ** 2,
                                 dim=tuple(range(1, x0.ndim)))
    return torch.mean(per_sample)


def make_loss_fn(sde: SDE, apply_fn: ScoreApply):
    """``loss_fn(params, batch, generator=None, *, t=None, z=None)``."""

    def loss_fn(params, batch: Tensor, generator=None, *, t=None, z=None) -> Tensor:
        return dsm_loss(sde, apply_fn, params, batch, generator, t=t, z=z)

    return loss_fn
