"""Quality-proxy gauges (DESIGN.md §15); port of
``repro/observability/quality.py``, numpy only, like the reference.

  * **proxy-FID**: the Fréchet distance between feature moments of two
    sample sets under a fixed, seeded random-projection extractor
    (Gaussian projection and tanh; no external weights, no download). It
    is a regression gauge (same extractor, same reference set, tracked
    over time), not a number comparable with a published FID.
  * **dynamics-consistency error**: for planning, the RMS residual of
    each plan's next-state rows against the environment's mean
    transition applied to the previous row (duck-typed over the
    analytic environments: an OU family with ``theta``, a double
    integrator with ``vel_cost``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def random_feature_extractor(sample_shape, dim: int = 32,
                             seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """A fixed (seeded) random-projection feature map for samples of
    ``sample_shape``: ``x → [z, tanh(z)]`` with ``z = x_flat @ W + b``,
    W ~ N(0, 1/flat). Deterministic in (shape, dim, seed), so two runs
    gauge against identical features — the property that makes the
    proxy comparable across PRs."""
    flat = int(np.prod(sample_shape))
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((flat, dim)) / np.sqrt(flat)).astype(np.float64)
    b = rng.uniform(-1.0, 1.0, size=(dim,))

    def feats(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
        if x.shape[1] != flat:
            raise ValueError(
                f"sample shape {x.shape[1:]} does not flatten to {flat}")
        z = x @ w + b
        return np.concatenate([z, np.tanh(z)], axis=-1)

    return feats


def feature_moments(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, covariance) of a (N, F) feature matrix (N ≥ 2)."""
    f = np.asarray(feats, np.float64)
    if f.ndim != 2 or f.shape[0] < 2:
        raise ValueError(f"need (N>=2, F) features, got {f.shape}")
    return f.mean(axis=0), np.cov(f, rowvar=False)


def _sqrtm_psd(m: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigh (negative eigenvalues from
    roundoff are clamped to 0)."""
    vals, vecs = np.linalg.eigh((m + m.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_from_moments(mu1, cov1, mu2, cov2) -> float:
    """Fréchet (2-Wasserstein²) distance between Gaussians fitted to two
    feature sets: |μ1−μ2|² + tr(C1 + C2 − 2·(C1^{1/2} C2 C1^{1/2})^{1/2})
    — the symmetric-PSD form, numerically safe for rank-deficient
    covariances (small sample counts)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    s1 = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(s1 @ cov2 @ s1)
    d2 = float(np.sum((mu1 - mu2) ** 2)
               + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(inner))
    return max(d2, 0.0)


def proxy_fid(x_ref, x_gen, *, dim: int = 32, seed: int = 0) -> float:
    """Cached-activation proxy-FID between a reference and a generated
    sample set (leading dim = samples; shapes must match past it). The
    extractor is a fixed random projection, so this needs no external
    weights — see module docstring for what that does and does not
    buy."""
    x_ref = np.asarray(x_ref)
    x_gen = np.asarray(x_gen)
    if x_ref.shape[1:] != x_gen.shape[1:]:
        raise ValueError(
            f"sample shapes differ: {x_ref.shape[1:]} vs {x_gen.shape[1:]}")
    feats = random_feature_extractor(x_ref.shape[1:], dim=dim, seed=seed)
    mu1, c1 = feature_moments(feats(x_ref))
    mu2, c2 = feature_moments(feats(x_gen))
    return frechet_from_moments(mu1, c1, mu2, c2)


def env_step_mean(env) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """The environment's *mean* transition s' = E[step(s, a)] as a
    vectorized numpy function over (..., obs_dim) states and (...,
    act_dim) actions, duck-typed over the analytic envs (DESIGN.md §10):

      * OU family (has ``theta``): s + dt·(−θ·s + a) — the closed-form
        mean of the σ√dt-noised step;
      * double integrator (has ``vel_cost``): [pos + dt·vel,
        vel + dt·a] — deterministic, so mean == step.
    """
    if hasattr(env, "theta"):
        dt, theta = float(env.dt), float(env.theta)
        return lambda s, a: s + dt * (-theta * s + a)
    if hasattr(env, "vel_cost"):
        dt, dim = float(env.dt), int(env.dim)

        def mean(s, a):
            pos, vel = s[..., :dim], s[..., dim:]
            return np.concatenate([pos + dt * vel, vel + dt * a], axis=-1)

        return mean
    raise TypeError(f"no mean-transition rule for {type(env).__name__}")


def dynamics_consistency(env, trajs, *, obs_dim: int, act_dim: int) -> float:
    """RMS env-step residual along sampled plans (DESIGN.md §15).

    ``trajs`` is (B, H, D) or (H, D) with rows ``[s_h, a_h]`` and
    ``D >= obs_dim + act_dim``; the gauge is the RMS over all (sample,
    transition, coordinate) of ``s_{h+1} − mean_step(s_h, a_h)``. For a
    stochastic env the floor is its noise scale (σ√dt for OU); for a
    deterministic env a perfect rollout scores 0.
    """
    x = np.asarray(trajs, np.float64)
    if x.ndim == 2:
        x = x[None]
    if x.ndim != 3 or x.shape[1] < 2:
        raise ValueError(f"need (B, H>=2, D) trajectories, got {x.shape}")
    s = x[:, :, :obs_dim]
    a = x[:, :, obs_dim:obs_dim + act_dim]
    pred = env_step_mean(env)(s[:, :-1], a[:, :-1])
    resid = s[:, 1:] - pred
    return float(np.sqrt(np.mean(resid ** 2)))
