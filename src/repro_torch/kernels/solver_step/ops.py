"""Wrappers of the solver-step kernels; port of
``repro/kernels/solver_step/ops.py`` (``em_step``, and ``error_step``,
which dispatches to ``error_step`` or ``error_step_vec`` in the
reference).

``em_step`` (K5) takes any (B, ...) state and three (B,) fp32
coefficients, flattens the state to (B, D) and returns
x' = c0·x + c1·score + c2·z with x's shape and dtype.

``error_step`` takes any (B, ...) state, flattens it to (B, D) and
returns (x'' with x's shape, e2 (B,) fp32). The tolerances may be floats
or (B,) tensors; floats are broadcast into (B,) fp32 tensors, so the
scalar and the per-sample form are one code path and a uniform vector
gives the scalar path's bits by construction.

Dispatch is by the device of the tensors: CPU tensors take the plain
versions (``ref.em_step``, ``ref.error_step``); CUDA tensors launch
``csrc/em_step.cu`` or ``csrc/solver_step.cu``, or raise. There is no
fallback from one to the other. ``em_launches`` counts K5's launches,
``launches`` those of K1/K2.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.solver_step import ref

Tensor = torch.Tensor

#: error_step (K1/K2) kernel launches since the count was last set to 0
launches = 0
#: em_step (K5) kernel launches since the count was last set to 0
em_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def per_sample_tolerance(eps, batch: int, device) -> Tensor:
    """A float or (B,)/0-d tensor tolerance → a (B,) fp32 tensor on ``device``."""
    if isinstance(eps, Tensor):
        if eps.shape != (batch,) and eps.ndim != 0:
            raise ValueError(f"tolerance shape {tuple(eps.shape)} != ({batch},)")
        return eps.to(device=device, dtype=torch.float32).expand(batch).contiguous()
    return torch.full((batch,), float(eps), dtype=torch.float32, device=device)


def _check(states, coeffs):
    x = states[0]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"state dtype {x.dtype} not in {list(_DTYPES)}")
    for a in states:
        if a.shape != x.shape or a.dtype != x.dtype or a.device != x.device:
            raise ValueError("state operands must share shape, dtype and device")
    for c in coeffs:
        if c.shape != (x.shape[0],) or c.dtype != torch.float32 or c.device != x.device:
            raise ValueError("coefficients must be (B,) float32 on the state's device")


def em_step(x, score, z, c0, c1, c2):
    """Fused x' = c0·x + c1·score + c2·z (fp32 math, x's dtype out)."""
    _check((x, score, z), (c0, c1, c2))
    B = x.shape[0]
    if x.device.type == "cpu":
        out = ref.em_step(*(a.reshape(B, -1) for a in (x, score, z)), c0, c1, c2)
    else:
        out = _launch_em(x, score, z, c0, c1, c2)
    return out.reshape(x.shape)


def error_step(x, x_prime, score2, z, x_prev, e0, d1, d2, *, eps_abs,
               eps_rel, use_prev: bool = True):
    """Fused x̃ / x'' / δ / scaled-ℓ2 error. Returns (x'', e2)."""
    B = x.shape[0]
    ea = per_sample_tolerance(eps_abs, B, x.device)
    er = per_sample_tolerance(eps_rel, B, x.device)
    _check((x, x_prime, score2, z, x_prev), (e0, d1, d2, ea, er))
    flat = [a.reshape(B, -1) for a in (x, x_prime, score2, z, x_prev)]
    if x.device.type == "cpu":
        xh, e2 = ref.error_step(*flat, e0, d1, d2, ea, er, use_prev=use_prev)
    else:
        xh, e2 = _launch(*flat, e0, d1, d2, ea, er, use_prev=use_prev)
    return xh.reshape(x.shape), e2


def _declare(lib):
    fn = lib.solver_step_error
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.solver_step_num_tiles.argtypes = [ctypes.c_longlong]
        lib.solver_step_num_tiles.restype = ctypes.c_int
        lib.solver_step_em.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
                                       + [ctypes.c_int, ctypes.c_void_p])
        lib.solver_step_em.restype = ctypes.c_int
    return lib


def _launch_em(x, s, z, c0, c1, c2):
    global em_launches
    states = (x, s, z)
    if not all(a.is_contiguous() for a in states + (c0, c1, c2)):
        raise ValueError("em_step kernel operands must be contiguous")
    if any(a.data_ptr() % 16 for a in states):
        raise ValueError("em_step kernel state operands must be 16-byte aligned")
    B = x.shape[0]
    if not 0 < B <= 65535:
        raise ValueError(f"batch {B} outside the kernel's grid limits 1..65535")
    lib = _declare(_build.library())
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.solver_step_em(*(a.data_ptr() for a in (x, s, z, c0, c1, c2)),
                                out.data_ptr(), B, x.numel() // B,
                                _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"em_step kernel launch failed: CUDA error {rc}")
    em_launches += 1
    return out


def _launch(x, xp, s2, z, xv, e0, d1, d2, ea, er, *, use_prev):
    global launches
    operands = (x, xp, s2, z, xv, e0, d1, d2, ea, er)
    if not all(a.is_contiguous() for a in operands):
        raise ValueError("solver_step kernel operands must be contiguous")
    B, D = x.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit 65535")
    lib = _declare(_build.library())
    xh = torch.empty_like(x)
    e2 = torch.empty(B, dtype=torch.float32, device=x.device)
    partial = torch.empty(B, lib.solver_step_num_tiles(D),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.solver_step_error(
            *(a.data_ptr() for a in operands), xh.data_ptr(), e2.data_ptr(),
            partial.data_ptr(), B, D, _DTYPES[x.dtype], int(use_prev), stream)
    if rc != 0:
        raise RuntimeError(f"solver_step kernel launch failed: CUDA error {rc}")
    launches += 1
    return xh, e2
