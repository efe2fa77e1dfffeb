"""Exact log-likelihood through the probability-flow ODE (Song et al. 2020a
App. D.2); port of ``repro/core/likelihood.py``.

Along dx/dt = f̃(x, t) = f − ½g²s, d/dt log p(x(t)) = −∇·f̃, so

  log p₀(x₀) = log p_T(x_T) + ∫₀^T ∇·f̃(x(t), t) dt.

The ODE and the integral run forward with fixed-step RK4 (``n_steps``
steps from t_eps to T); the divergence is taken at each step's midpoint.
It is either exact (the trace of each sample's Jacobian through
``torch.func.vmap`` of ``torch.func.jacrev``: d backward passes, for
small d and for the tests) or Hutchinson's estimate (Rademacher probes
through ``torch.func.jvp``, the path for images), with the probes drawn
from an explicit ``torch.Generator``. The reference draws its probes from
a JAX key, so the two Hutchinson estimates differ by their probes; the
exact mode agrees with the reference to fp32 rounding.

The score function must be differentiable in x with ``torch.func``
(plain torch operations, no in-place updates of its input).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.sde import SDE
from repro_torch.core.solvers.base import fma32
from repro_torch.device import resolve_device

Tensor = torch.Tensor


def _divergence_exact(fn: Callable, x: Tensor, t: Tensor) -> Tensor:
    """∇·fn per sample through the exact Jacobian trace. x (B, d)."""

    def single(xi, ti):
        return fn(xi[None, :], ti[None])[0]

    jac = torch.func.vmap(torch.func.jacrev(single))(x, t)
    return torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1)


def _divergence_hutchinson(fn: Callable, x: Tensor, t: Tensor,
                           generator: torch.Generator, probes: int) -> Tensor:
    """Unbiased ∇·fn from Rademacher probes ε: the mean of εᵀ(∂fn/∂x)ε,
    all probes in one vectorised forward-mode pass."""
    eps = torch.randint(0, 2, (probes,) + tuple(x.shape), generator=generator,
                        device=x.device)
    eps = (2 * eps - 1).to(x.dtype)
    one = lambda e: torch.func.jvp(lambda v: fn(v, t), (x,), (e,))[1]
    return (torch.func.vmap(one)(eps) * eps).sum(dim=2).mean(dim=0)


def log_likelihood(sde: SDE, score_fn: Callable, x0: Tensor, *,
                   n_steps: int = 200, method: str = "exact",
                   generator: torch.Generator | None = None, probes: int = 8,
                   device="cuda") -> Tensor:
    """log p₀(x₀) per sample in nats, on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``). x0 (B, ...) is flattened internally.
    ``method`` is ``"exact"`` (small d) or ``"hutchinson"``, which needs
    ``generator`` for its probes."""
    dev = resolve_device(device)
    x0 = x0.to(device=dev, dtype=torch.float32)
    B, shape = x0.shape[0], x0.shape[1:]
    d = math.prod(shape)

    def ode_fn(x: Tensor, t: Tensor) -> Tensor:
        # batch-size-polymorphic: the exact divergence calls it with
        # single samples (B = 1) inside vmap
        xs = x.reshape((-1,) + tuple(shape))
        return sde.ode_drift(xs, t, score_fn(xs, t)).reshape(x.shape[0], d)

    if method == "exact":
        div = lambda x, t: _divergence_exact(ode_fn, x, t)
    elif method == "hutchinson":
        if generator is None:
            raise ValueError("the Hutchinson estimate needs a generator for its probes")
        div = lambda x, t: _divergence_hutchinson(ode_fn, x, t, generator, probes)
    else:
        raise ValueError(f"unknown method {method!r} (want 'exact' | 'hutchinson')")

    h = (sde.T - sde.t_eps) / n_steps
    f32 = dict(dtype=torch.float32, device=dev)
    h32, t_eps32 = torch.tensor(h, **f32), torch.tensor(sde.t_eps, **f32)
    x, acc = x0.reshape(B, d), torch.zeros(B, **f32)
    for i in range(n_steps):
        # t_eps + i·h as the reference's XLA code rounds it (one fused
        # multiply-add), for every sample
        t = fma32(torch.tensor(float(i), **f32), h32, t_eps32).expand(B).contiguous()
        with torch.no_grad():
            k1 = ode_fn(x, t)
            k2 = ode_fn(x + 0.5 * h * k1, t + 0.5 * h)
            k3 = ode_fn(x + 0.5 * h * k2, t + 0.5 * h)
            k4 = ode_fn(x + h * k3, t + h)
        # the divergence at the midpoint (second-order quadrature)
        dv = div(x + 0.5 * h * k1, t + 0.5 * h).detach()
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        acc = acc + h * dv

    ps = sde.prior_std()
    log_p_T = -0.5 * (torch.sum((x / ps) ** 2, dim=1)
                      + d * math.log(2 * math.pi * ps * ps))
    return log_p_T + acc


def bits_per_dim(sde: SDE, score_fn: Callable, x0: Tensor, **kw) -> Tensor:
    """Bits per dimension of 8-bit data in ``sde.value_range``: a bin of
    width Δ = (hi − lo)/256 has probability ≈ p(x)·Δ, so
    bpd = −(log p + d·log Δ)/(d·log 2)."""
    d = math.prod(x0.shape[1:])
    ll = log_likelihood(sde, score_fn, x0, **kw)
    lo, hi = sde.value_range
    return -(ll / d + math.log((hi - lo) / 256.0)) / math.log(2.0)
