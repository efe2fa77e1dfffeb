"""Mixed tolerance and scaled error norms; port of ``repro/core/tolerance.py``.

    δ(x', x'_prev) = max(ε_abs, ε_rel · max(|x'|, |x'_prev|))     (Eq. 5)
    E₂ = sqrt(mean(((x' − x'') / δ)²))                            (Sec. 3.1.3)

Control-path math (DESIGN.md §8): every function upcasts its tensor
inputs to fp32 and returns fp32, whatever dtype the state runs in.
Reductions are per sample: state is (B, ...) and norms reduce over every
axis but the first, returning (B,).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def mixed_tolerance(x_low: Tensor, x_prev: Tensor | None, eps_abs,
                    eps_rel) -> Tensor:
    """δ per element (fp32). ``x_prev=None`` is the δ(x') variant (Eq. 4).

    ``eps_abs``/``eps_rel`` are Python floats or fp32 tensors that
    broadcast against ``x_low`` (per-sample tolerances expanded to
    (B, 1, ..., 1)).
    """
    mag = torch.abs(x_low.to(torch.float32))
    if x_prev is not None:
        mag = torch.maximum(mag, torch.abs(x_prev.to(torch.float32)))
    rel = eps_rel * mag
    if isinstance(eps_abs, Tensor):
        return torch.maximum(eps_abs, rel)
    return torch.clamp(rel, min=eps_abs)


def _reduce_dims(x: Tensor) -> tuple:
    return tuple(range(1, x.ndim))


def scaled_error_l2(x_low: Tensor, x_high: Tensor, delta: Tensor) -> Tensor:
    """Per-sample E₂ = ||(x' − x'')/δ||₂ / sqrt(n); fp32, shape (B,)."""
    r = (x_low.to(torch.float32) - x_high.to(torch.float32)) / delta
    return torch.sqrt(torch.mean(r * r, dim=_reduce_dims(x_low)))


def scaled_error_linf(x_low: Tensor, x_high: Tensor, delta: Tensor) -> Tensor:
    """Per-sample E∞ (ablation variant); fp32, shape (B,)."""
    r = torch.abs((x_low.to(torch.float32) - x_high.to(torch.float32)) / delta)
    return torch.amax(r, dim=_reduce_dims(x_low))


def next_step_size(h: Tensor, err: Tensor, t_remaining: Tensor, *,
                   safety: float = 0.9, r_exponent: float = 0.9,
                   h_min: float = 0.0) -> Tensor:
    """h ← clip(θ · h · E^{-r}, h_min, t_remaining)  (paper Sec. 3.1.4).

    ``err`` is clamped below at 1e-8 so that h stays finite when the
    error is ~0. fp32 whatever the state dtype.
    """
    err = torch.clamp(err.to(torch.float32), min=1e-8)
    h_new = safety * h * torch.pow(err, -r_exponent)
    upper = torch.clamp(t_remaining, min=h_min)
    return torch.minimum(torch.clamp(h_new, min=h_min), upper)
