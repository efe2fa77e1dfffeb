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

``error_step`` returns (x'' in the operand dtype, e2 fp32), ``em_step``
x' in the operand dtype. All arithmetic runs in fp32, whatever the
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


def error_step(x: Tensor, x_prime: Tensor, score2: Tensor, z: Tensor,
               x_prev: Tensor, e0: Tensor, d1: Tensor, d2: Tensor,
               eps_abs: Tensor, eps_rel: Tensor, *, use_prev: bool = True):
    out_dtype = x.dtype
    x, x_prime, score2, z, x_prev = (
        a.to(torch.float32) for a in (x, x_prime, score2, z, x_prev))
    col = lambda v: v.to(torch.float32)[:, None]
    x_tilde = x - col(e0) * x_prime + col(d1) * score2 + col(d2) * z
    x_high = 0.5 * (x_prime + x_tilde)
    mag = torch.abs(x_prime)
    if use_prev:
        mag = torch.maximum(mag, torch.abs(x_prev))
    delta = torch.maximum(col(eps_abs), col(eps_rel) * mag)
    r = (x_prime - x_high) / delta
    e2 = torch.sqrt(torch.mean(r * r, dim=1))
    return x_high.to(out_dtype), e2
