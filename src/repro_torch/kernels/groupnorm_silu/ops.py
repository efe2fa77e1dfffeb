"""Wrapper of the fused GroupNorm → SiLU kernel; port of
``repro/kernels/groupnorm_silu/ops.py``.

``groupnorm_silu(x, scale, bias, groups=g)`` takes x (B, H, C) fp32 or
bf16, contiguous, and scale/bias (C,) of any float dtype, which apply
in fp32. The group count resolves as the temporal UNet's does,
g = min(groups, C), and C must be a multiple of g. The reference builds
a one-hot (C, g) membership matrix for its MXU lane fold; the CUDA
kernel reduces over each group's channels directly and needs none.

Dispatch is by the device of the tensors: CPU tensors take the plain
version (``ref.groupnorm_silu``); CUDA tensors launch
``csrc/groupnorm_silu.cu`` or raise. There is no fallback from one to
the other. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.groupnorm_silu import ref

Tensor = torch.Tensor

#: kernel launches since the count was last set to 0
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: one (sample, group) slab is staged in shared memory as fp32; 48 KB is
#: what a block may take without opting in to more
MAX_SLAB = 48 * 1024 // 4


def _check(x, scale, bias):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"x must be (B, H, C), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    C = x.shape[2]
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (C,) or not p.dtype.is_floating_point or p.device != x.device:
            raise ValueError(f"{name} must be a float ({C},) tensor on x's device")


def groupnorm_silu(x: Tensor, scale: Tensor, bias: Tensor, *, groups: int,
                   eps: float = 1e-6) -> Tensor:
    """silu(groupnorm(x)·scale + bias); x (B, H, C) → (B, H, C) in x's
    dtype, rounded once."""
    _check(x, scale, bias)
    C = x.shape[2]
    g = min(groups, C)
    if C % g:
        raise ValueError(f"channels {C} not divisible by groups {g}")
    if x.device.type == "cpu":
        return ref.groupnorm_silu(x, scale, bias, groups=groups, eps=eps)
    return _launch(x, scale, bias, groups=g, eps=eps)


def _declare(lib):
    fn = lib.groupnorm_silu_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(x, scale, bias, *, groups, eps):
    global launches
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu kernel needs a contiguous x")
    B, H, C = x.shape
    if H * (C // groups) > MAX_SLAB:
        raise ValueError(f"slab H*C/g = {H * (C // groups)} exceeds {MAX_SLAB}")
    lib = _declare(_build.library())
    s32 = scale.to(torch.float32).contiguous()
    b32 = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.groupnorm_silu_fwd(
            x.data_ptr(), s32.data_ptr(), b32.data_ptr(), out.data_ptr(),
            B, H, C, groups, float(eps), _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
