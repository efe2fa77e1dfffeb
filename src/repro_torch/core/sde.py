"""Forward diffusion processes (SDEs); port of ``repro/core/sde.py``.

  VE :  dx = sqrt(d[sigma^2(t)]/dt) dw,   sigma(t) = smin (smax/smin)^t
  VP :  dx = -1/2 beta(t) x dt + sqrt(beta(t)) dw,
        beta(t) = bmin + t (bmax - bmin)

plus sub-VP. The processes are plain frozen dataclasses whose methods
take tensors: ``t`` is a scalar, a 0-d tensor or a ``(B,)`` vector and is
computed in fp32 on the device of the tensor it arrives on (a Python
float becomes a CPU fp32 scalar tensor). The arithmetic keeps the
reference's operation order so that both packages round alike.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.streams import SlotStreams

Tensor = torch.Tensor


def _f32(t) -> Tensor:
    """Scalar or tensor → fp32 tensor (the control dtype)."""
    if isinstance(t, Tensor):
        return t.to(torch.float32)
    return torch.tensor(t, dtype=torch.float32)


def bcast(t: Tensor, x: Tensor) -> Tensor:
    """Broadcast a per-sample ``(B,)`` vector against state ``(B, ...)``."""
    if t.ndim == 0:
        return t
    return t.reshape(t.shape + (1,) * (x.ndim - t.ndim))


@dataclasses.dataclass(frozen=True)
class SDE:
    """Abstract forward diffusion dx = f(x,t) dt + g(t) dw on t in [0, 1]."""

    T: float = 1.0
    t_eps: float = 1e-3

    def drift_coeff(self, t) -> Tensor:
        """a(t) with f(x, t) = a(t)·x (every drift here is linear)."""
        raise NotImplementedError

    def drift(self, x: Tensor, t) -> Tensor:
        """Forward drift f(x, t)."""
        raise NotImplementedError

    def reverse_drift(self, x: Tensor, t, score: Tensor) -> Tensor:
        """Drift of the reverse SDE: f(x, t) − g(t)² · score."""
        g = bcast(self.diffusion(t), x)
        return self.drift(x, t) - g * g * score

    def ode_drift(self, x: Tensor, t, score: Tensor) -> Tensor:
        """Drift of the probability-flow ODE: f(x, t) − ½ g(t)² · score."""
        g = bcast(self.diffusion(t), x)
        return self.drift(x, t) - 0.5 * g * g * score

    def diffusion(self, t) -> Tensor:
        raise NotImplementedError

    def marginal(self, t) -> Tuple[Tensor, Tensor]:
        """(mean_scale(t), std(t)) of the transition kernel p(x_t | x_0)."""
        raise NotImplementedError

    def perturb(self, x0: Tensor, t, z: Tensor) -> Tensor:
        """Single-step forward corruption x_t = m(t)·x0 + s(t)·z."""
        m, s = self.marginal(t)
        return bcast(m, x0) * x0 + bcast(s, x0) * z

    def kernel_score(self, xt: Tensor, x0: Tensor, t) -> Tensor:
        """∇_{x_t} log p(x_t | x_0), the DSM regression target."""
        m, s = self.marginal(t)
        return -(xt - bcast(m, x0) * x0) / bcast(s, x0) ** 2

    def loss_weight(self, t) -> Tensor:
        """λ(t) ∝ 1 / E‖∇ log p(x_t|x_0)‖² = std(t)² (paper Sec. 2.1)."""
        _, s = self.marginal(t)
        return s ** 2

    def prior_std(self) -> float:
        raise NotImplementedError

    def prior_sample(self, shape, generator) -> Tensor:
        """x_T ~ N(0, prior_std² I) in fp32, drawn from ``generator`` on
        the generator's device: a ``torch.Generator``, or per-slot
        streams (``streams.SlotStreams``), whose row i is the draw
        of stream i at its counter (a request's prior is its stream's
        draw at counter 0); ``shape`` then leads with the streams' B."""
        if isinstance(generator, SlotStreams):
            if shape[0] != generator.seed.shape[0]:
                raise ValueError(f"prior of {shape[0]} rows from "
                                 f"{generator.seed.shape[0]} streams")
            z = generator.draw(tuple(shape)[1:])
        else:
            z = torch.randn(tuple(shape), generator=generator,
                            dtype=torch.float32, device=generator.device)
        return z * self.prior_std()

    def tweedie_denoise(self, x: Tensor, score: Tensor) -> Tensor:
        """Exact Tweedie posterior mean at t = t_eps:
        E[x0 | x_t] = (x_t + std(t)² · ∇log p_t(x_t)) / m(t).
        (The reference documents its erratum against the paper's App. D.)
        """
        m, s = self.marginal(torch.tensor(self.t_eps, dtype=torch.float32,
                                          device=x.device))
        return (x + (s * s) * score) / m

    @property
    def value_range(self) -> Tuple[float, float]:
        raise NotImplementedError

    @property
    def abs_tolerance(self) -> float:
        """ε_abs = (y_max − y_min)/256 (paper Sec. 3.1.3)."""
        lo, hi = self.value_range
        return (hi - lo) / 256.0


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
    """Variance-exploding process. Data range [0, 1] by convention."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0
    t_eps: float = 1e-5

    def sigma(self, t) -> Tensor:
        t = _f32(t)
        return self.sigma_min * torch.pow(self.sigma_max / self.sigma_min, t)

    def drift_coeff(self, t) -> Tensor:
        return torch.zeros_like(_f32(t))

    def drift(self, x: Tensor, t) -> Tensor:
        return torch.zeros_like(x)

    def diffusion(self, t) -> Tensor:
        sig = self.sigma(t)
        # the reference takes log and sqrt of the ratio in fp32 (a fill on
        # the device, so that a CUDA graph can capture it)
        ratio = torch.full((), self.sigma_max / self.sigma_min,
                           dtype=torch.float32, device=sig.device)
        return sig * torch.sqrt(2.0 * torch.log(ratio))

    def marginal(self, t) -> Tuple[Tensor, Tensor]:
        t = _f32(t)
        return torch.ones_like(t), self.sigma(t)

    def prior_std(self) -> float:
        return self.sigma_max

    @property
    def value_range(self) -> Tuple[float, float]:
        return (0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
    """Variance-preserving process. Data range [-1, 1] by convention."""

    beta_min: float = 0.1
    beta_max: float = 20.0
    t_eps: float = 1e-3

    def beta(self, t) -> Tensor:
        return self.beta_min + _f32(t) * (self.beta_max - self.beta_min)

    def _int_beta(self, t) -> Tensor:
        t = _f32(t)
        return self.beta_min * t + 0.5 * (t * t) * (self.beta_max - self.beta_min)

    def drift_coeff(self, t) -> Tensor:
        return -0.5 * self.beta(t)

    def drift(self, x: Tensor, t) -> Tensor:
        return -0.5 * bcast(self.beta(t), x) * x

    def diffusion(self, t) -> Tensor:
        return torch.sqrt(self.beta(t))

    def marginal(self, t) -> Tuple[Tensor, Tensor]:
        ib = self._int_beta(t)
        mean_scale = torch.exp(-0.5 * ib)
        std = torch.sqrt(torch.clamp(1.0 - torch.exp(-ib), min=1e-12))
        return mean_scale, std

    def prior_std(self) -> float:
        return 1.0

    @property
    def value_range(self) -> Tuple[float, float]:
        return (-1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class SubVPSDE(VPSDE):
    """sub-VP process of Song et al. 2020a."""

    def diffusion(self, t) -> Tensor:
        ib = self._int_beta(t)
        return torch.sqrt(self.beta(t) * (1.0 - torch.exp(-2.0 * ib)))

    def marginal(self, t) -> Tuple[Tensor, Tensor]:
        ib = self._int_beta(t)
        mean_scale = torch.exp(-0.5 * ib)
        std = torch.clamp(1.0 - torch.exp(-ib), min=1e-12)
        return mean_scale, std


def get_sde(name: str, **kw) -> SDE:
    name = name.lower()
    if name == "ve":
        return VESDE(**kw)
    if name == "vp":
        return VPSDE(**kw)
    if name in ("subvp", "sub-vp"):
        return SubVPSDE(**kw)
    raise ValueError(f"unknown SDE '{name}' (want 've'|'vp'|'subvp')")

