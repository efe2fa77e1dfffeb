"""Plain PyTorch versions of the solver-step kernels; port of
``repro/kernels/solver_step/ref.py``.

Shapes: state tensors are (B, D); per-sample coefficients and the
tolerances are (B,) fp32.

``em_step`` (K5), the update of every fixed-grid stochastic baseline:

    x' = c0·x + c1·score + c2·z

``error_step`` (K1/K2), the Algorithm-1 step after its two scores:

    x̃  = x − e0·x' + d1·score2 + d2·z
    x'' = ½ (x' + x̃)
    δ   = max(ε_abs, ε_rel · max(|x'|, |x'_prev|))     [or |x'| only]
    e2  = sqrt(mean(((x' − x'')/δ)²))                  per sample

``error_step_sums`` (K4's per-rank partial) is ``error_step`` on one
rank's block of columns with the row sum Σ r² in place of e2; the
ranks that split the columns add their sums and take sqrt(Σ / D).

``error_step`` returns (x'' in the operand dtype, e2 fp32),
``error_step_sums`` (x'', Σ r² fp32), ``em_step`` x' in the operand
dtype. All arithmetic runs in fp32, whatever the
operand dtype, and the result is rounded once, on return. This is what
the CUDA kernels compute, and what the wrappers run for CPU tensors.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def em_step(x: Tensor, score: Tensor, z: Tensor, c0: Tensor, c1: Tensor,
            c2: Tensor) -> Tensor:
    col = lambda v: v.to(torch.float32)[:, None]
    out = (col(c0) * x.to(torch.float32) + col(c1) * score.to(torch.float32)
           + col(c2) * z.to(torch.float32))
    return out.to(x.dtype)


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """fp32 a·b + c rounded once, as a fused multiply-add: the product of
    two fp32 values is exact in fp64 (the sum's one fp64 rounding can in
    rare cases differ from a single fp32 rounding)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def _residual(x, x_prime, score2, z, x_prev, e0, d1, d2, eps_abs, eps_rel,
              use_prev):
    """(x'' fp32, scaled residual r fp32) of the step, both (B, D).

    x̃ is three fused multiply-adds, x − e0·x' first, as the CUDA kernel
    (nvcc contracts the expression) and the reference's Pallas kernel
    (XLA's CPU code contracts it too) round it; x'' then has their bits.
    """
    x, x_prime, score2, z, x_prev = (
        a.to(torch.float32) for a in (x, x_prime, score2, z, x_prev))
    col = lambda v: v.to(torch.float32)[:, None]
    x_tilde = _fma(col(d2), z, _fma(col(d1), score2, _fma(-col(e0), x_prime, x)))
    x_high = 0.5 * (x_prime + x_tilde)
    mag = torch.abs(x_prime)
    if use_prev:
        mag = torch.maximum(mag, torch.abs(x_prev))
    delta = torch.maximum(col(eps_abs), col(eps_rel) * mag)
    return x_high, (x_prime - x_high) / delta


def error_step(x: Tensor, x_prime: Tensor, score2: Tensor, z: Tensor,
               x_prev: Tensor, e0: Tensor, d1: Tensor, d2: Tensor,
               eps_abs: Tensor, eps_rel: Tensor, *, use_prev: bool = True):
    x_high, r = _residual(x, x_prime, score2, z, x_prev, e0, d1, d2, eps_abs,
                          eps_rel, use_prev)
    e2 = torch.sqrt(torch.mean(r * r, dim=1))
    return x_high.to(x.dtype), e2


def error_step_sums(x: Tensor, x_prime: Tensor, score2: Tensor, z: Tensor,
                    x_prev: Tensor, e0: Tensor, d1: Tensor, d2: Tensor,
                    eps_abs: Tensor, eps_rel: Tensor, *, use_prev: bool = True):
    """K4's per-rank partial: (x'' in the operand dtype, Σ r² per row fp32)
    over the block's columns, before any normalisation."""
    x_high, r = _residual(x, x_prime, score2, z, x_prev, e0, d1, d2, eps_abs,
                          eps_rel, use_prev)
    return x_high.to(x.dtype), torch.sum(r * r, dim=1)
