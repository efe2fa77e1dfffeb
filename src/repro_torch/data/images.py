"""Synthetic data with analytically known structure; port of
``repro/data/images.py``.

* ``GMMImageConfig`` / ``sample_images``: each image is a draw from a
  K-component Gaussian mixture in a low-dimensional latent, decoded
  through a fixed random linear map and tanh into the value range.
* ``GMM2D``: the 2-D mixture of the solver benchmarks, whose score is
  exact in closed form at every t.

The reference draws the image generator's parameters (means, basis,
scales) from ``jax.random.PRNGKey(cfg.seed)``; the port draws its own
from a ``torch.Generator`` seeded with ``cfg.seed``. They are another
instance of the same family of distributions, not the reference's
instance: quality in the port is judged against the port's own
``data_moments``. ``sample_images`` takes ``params=`` (numpy arrays or
tensors), so tests can pass the reference's parameters in, and ``comp=``
/ ``z=`` in place of the component and latent draws. ``GMM2D`` is
constants only, so its ``score_at_time`` is the reference's function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GMMImageConfig:
    image_size: int = 32
    channels: int = 3
    latent_dim: int = 16
    n_components: int = 8
    seed: int = 1234
    value_range: Tuple[float, float] = (-1.0, 1.0)  # the VP convention


def generator_params(cfg: GMMImageConfig, device="cpu") -> Tuple[Tensor, Tensor, Tensor]:
    """(means (K, L), basis (L, d), scales (K,)), fp32, drawn in that
    order from a generator seeded ``cfg.seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    f32 = dict(generator=g, dtype=torch.float32, device=device)
    means = 2.0 * torch.randn(cfg.n_components, cfg.latent_dim, **f32)
    d = cfg.image_size * cfg.image_size * cfg.channels
    basis = torch.randn(cfg.latent_dim, d, **f32) / cfg.latent_dim ** 0.5
    scales = 0.3 + 0.7 * torch.rand(cfg.n_components, **f32)
    return means, basis, scales


def sample_images(cfg: GMMImageConfig, generator: Optional[torch.Generator], n: int, *,
                  params=None, comp: Optional[Tensor] = None,
                  z: Optional[Tensor] = None) -> Tensor:
    """n images (n, H, W, C) fp32 in ``cfg.value_range``.

    ``params`` (means, basis, scales) defaults to ``generator_params(cfg)``
    on the generator's device; the component index and the latent z are
    drawn from ``generator`` (that order) unless ``comp`` / ``z`` are given.
    """
    dev = generator.device if generator is not None else (
        z.device if z is not None else torch.device("cpu"))
    if params is None:
        params = generator_params(cfg, dev)
    means, basis, scales = (torch.as_tensor(p, dtype=torch.float32).to(dev) for p in params)
    if comp is None:
        comp = torch.randint(0, cfg.n_components, (n,), generator=generator, device=dev)
    if z is None:
        z = torch.randn(n, cfg.latent_dim, generator=generator, dtype=torch.float32,
                        device=dev)
    comp = torch.as_tensor(comp).to(dev).long()
    z = means[comp] + scales[comp][:, None] * torch.as_tensor(z).to(dev)
    flat = torch.tanh(z @ basis)
    lo, hi = cfg.value_range
    flat = lo + (hi - lo) * (flat + 1.0) / 2.0
    return flat.reshape(n, cfg.image_size, cfg.image_size, cfg.channels)


def data_moments(cfg: GMMImageConfig, n: int = 8192, seed: int = 7,
                 device="cpu") -> Tuple[Tensor, Tensor]:
    """Monte-Carlo per-pixel mean and variance of the data, (d,) each."""
    x = sample_images(cfg, torch.Generator(device=device).manual_seed(seed), n)
    flat = x.reshape(n, -1)
    mu = torch.mean(flat, dim=0)
    xc = flat - mu
    return mu, torch.mean(xc * xc, dim=0)


@dataclasses.dataclass(frozen=True)
class GMM2D:
    """4-mode 2-D Gaussian mixture with an exact score at every t."""

    means: tuple = ((-2.0, -2.0), (2.0, 2.0), (-2.0, 2.0), (2.0, -2.0))
    std: float = 0.5
    weights: tuple = (0.25, 0.25, 0.25, 0.25)

    def sample(self, generator: torch.Generator, n: int) -> Tensor:
        """n draws (n, 2) fp32 on the generator's device: the component,
        then the Gaussian offset."""
        dev = generator.device
        w = torch.tensor(self.weights, dtype=torch.float32, device=dev)
        comp = torch.multinomial(w, n, replacement=True, generator=generator)
        z = torch.randn(n, 2, generator=generator, dtype=torch.float32, device=dev)
        return torch.tensor(self.means, dtype=torch.float32, device=dev)[comp] + self.std * z

    def score_at_time(self, sde):
        """Exact ∇log p_t of this mixture diffused by ``sde``."""

        consts = {}  # device → (means, weights), made once per device

        def score(x: Tensor, t: Tensor) -> Tensor:
            if x.device not in consts:
                consts[x.device] = tuple(
                    torch.tensor(v, dtype=torch.float32, device=x.device)
                    for v in (self.means, self.weights))
            means, w = consts[x.device]
            m, s = sde.marginal(t)                          # (B,)
            mu_t = m[:, None, None] * means[None]           # (B, K, 2)
            var_t = (m * self.std) ** 2 + s ** 2            # (B,)
            diff = x[:, None, :] - mu_t                     # (B, K, 2)
            sq = torch.sum(diff * diff, dim=-1)             # (B, K)
            logw = (torch.log(w)[None] - 0.5 * sq / var_t[:, None]
                    - torch.log(var_t[:, None]))
            post = torch.softmax(logw, dim=-1)              # (B, K)
            return -torch.einsum("bk,bkd->bd", post, diff) / var_t[:, None]

        return score
