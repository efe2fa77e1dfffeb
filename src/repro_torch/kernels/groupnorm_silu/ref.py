"""Plain PyTorch version of fused GroupNorm → SiLU; port of
``repro/kernels/groupnorm_silu/ref.py``.

x (B, H, C); scale/bias (C,). Statistics are per (sample, group) over
the (H, C/g) slab with g = min(groups, C): the mean first, then the mean
of squared deviations (two passes, fp32), rsqrt of (var + eps). The
normalisation, the affine step and the SiLU run in fp32 whatever the
operand dtype, and the output is rounded once, to x's dtype. This is
what the CUDA kernel computes, and what the wrapper runs for CPU
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def groupnorm_silu(x: Tensor, scale: Tensor, bias: Tensor, *, groups: int,
                   eps: float = 1e-6) -> Tensor:
    B, H, C = x.shape
    g = min(groups, C)
    xg = x.reshape(B, H, g, C // g).to(torch.float32)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    d = xg - mu
    var = (d * d).mean(dim=(1, 3), keepdim=True)
    xn = (d * torch.rsqrt(var + eps)).reshape(B, H, C)
    y = xn * scale.to(torch.float32) + bias.to(torch.float32)
    return F.silu(y).to(x.dtype)
