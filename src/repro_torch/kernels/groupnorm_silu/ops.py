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
the other, and the launch refuses inputs that require grad under grad
mode (``kernels.autograd``: the kernel has no backward). ``launches`` counts kernel launches, one a call.
A call made while the stream is captured into a CUDA graph launches
nothing: it counts in ``captured``, and whoever replays the graph charges
``launches`` with its replays (``graph_loop.ops.WhileDriver``).

The CUDA source holds two kernels; ``kernel_config`` picks one before
the launch from the shape, the dtype and the operands' alignment: the
register path (a team of lanes holds a slab in registers and reduces it
with shuffles) for slabs of up to ``REG_SLAB`` elements where g and
C/(4g) are powers of two (the temporal UNet's 8 groups of 4, 8 or 16
channels), else the general path (one block a slab, staged in shared
memory), up to ``MAX_SLAB``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import refuse_autograd
from repro_torch.kernels.groupnorm_silu import ref

Tensor = torch.Tensor

#: kernel launches since the count was last set to 0
launches = 0
#: kernels recorded into CUDA graphs under capture (not launched)
captured = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: one (sample, group) slab is staged in shared memory as fp32; 48 KB is
#: what a block may take without opting in to more
MAX_SLAB = 48 * 1024 // 4
#: the register path's largest slab (``kRegSlab`` in the CUDA source):
#: 32 lanes of 8 four-element vectors
REG_SLAB = 1024
#: threads of a block: the general path's (``kThreads``), and the most a
#: register-path block takes (four warps)
THREADS, REG_THREADS = 256, 128


def kernel_config(B: int, H: int, C: int, groups: int, dtype, aligned: bool) -> dict:
    """The kernel and launch shape for x (B, H, C) in ``dtype`` with
    ``groups`` groups (clamped to C, as the wrapper does). ``aligned``
    says that x and out start on a multiple of their four-element vector
    (16 bytes in fp32, 8 in bf16) and scale and bias on 16 bytes.

    Returns ``path`` ("register" or "general"), ``team`` lanes a slab and
    ``vecs`` four-element vectors a lane (0 on the general path, where a
    block takes one slab), ``threads`` a block, ``grid`` blocks, and
    ``load_bytes``, the width of one load of x. Pure Python: the tests
    cover the choice on the CPU, and the launch passes it to the kernel.
    """
    g = min(groups, C)
    cg = C // g
    n = H * cg
    slabs = B * g
    size = dtype.itemsize
    pow2 = lambda v: v & (v - 1) == 0
    if cg % 4 or not pow2(g) or not pow2(cg // 4) or not aligned or n > REG_SLAB:
        return dict(path="general", team=0, vecs=0, threads=THREADS, grid=slabs,
                    load_bytes=size)
    nvec = n // 4
    team = min(32, 1 << (nvec - 1).bit_length())
    vecs = 1 << (-(-nvec // team) - 1).bit_length()
    threads = min(REG_THREADS, -(-slabs * team // 32) * 32)
    return dict(path="register", team=team, vecs=vecs, threads=threads,
                grid=-(-slabs // (threads // team)), load_bytes=4 * size)


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
                       + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(x, scale, bias, *, groups, eps, path=None):
    """The kernel on CUDA tensors; ``path="general"`` forces the general
    kernel (tests and timings compare the two; the model never passes
    it)."""
    global launches, captured
    refuse_autograd("groupnorm_silu", x, scale, bias)
    if path not in (None, "general"):
        raise ValueError(f"path must be None or 'general', got {path!r}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu kernel needs a contiguous x")
    B, H, C = x.shape
    if H * (C // groups) > MAX_SLAB:
        raise ValueError(f"slab H*C/g = {H * (C // groups)} exceeds {MAX_SLAB}")
    lib = _declare(_build.library())
    s32 = scale.to(torch.float32).contiguous()
    b32 = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    vec = 4 * x.element_size()
    aligned = (x.data_ptr() % vec == 0 and out.data_ptr() % vec == 0
               and s32.data_ptr() % 16 == 0 and b32.data_ptr() % 16 == 0)
    cfg = kernel_config(B, H, C, groups, x.dtype, aligned and path != "general")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.groupnorm_silu_fwd(
            x.data_ptr(), s32.data_ptr(), b32.data_ptr(), out.data_ptr(),
            B, H, C, groups, float(eps), _DTYPES[x.dtype],
            int(cfg["path"] == "register"), cfg["team"], cfg["vecs"], cfg["threads"], stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out
