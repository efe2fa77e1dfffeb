"""Wrapper of the chunked SSD scan kernel (K7); port of
``repro/kernels/ssd/ops.py``.

``ssd_scan(x, dt, A, Bm, C)`` takes the model's layout: x (B, S, H, P),
dt (B, S, H) fp32, A (H,) fp32, Bm and C (B, S, G, N) in x's dtype
(fp32 or bf16), H % G == 0, and returns y (B, S, H, P) in x's dtype
(with ``return_state=True`` also the state after the last position,
(B, H, N, P) fp32). The reference transposes to head-major layout and
pads S to the chunk; the CUDA kernel reads the model's layout and masks
a ragged S, so nothing is transposed or padded.

Dispatch is by the device of the tensors: CPU tensors take the plain
version (``ref.ssd_chunked``, chunk ``CHUNK``); CUDA tensors launch
``csrc/ssd_scan.cu`` (chunk ``KERNEL_CHUNK``, which changes only the
rounding) or raise. There is no fallback from one to the other.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ref

Tensor = torch.Tensor

#: kernel launches since the count was last set to 0
launches = 0

#: the plain version's chunk (the reference's DEFAULT_CHUNK)
CHUNK = 128
#: the kernel's chunk: one chunk's operands, scores and state fit in a
#: block's shared memory at d_state 128, head_dim 64
KERNEL_CHUNK = 64
#: the shapes the kernel takes: d_state and head_dim multiples of 16 up to these
MAX_D_STATE, MAX_HEAD_DIM = 128, 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, A, Bm, C):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 4 or Bm.ndim != 4:
        raise ValueError(f"x and Bm must be (B, S, H, P) and (B, S, G, N), got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    B, S, H, P = x.shape
    G = Bm.shape[2]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if Bm.shape[:2] != (B, S) or C.shape != Bm.shape or H % G:
        raise ValueError(f"Bm/C {tuple(Bm.shape)}/{tuple(C.shape)} do not fit x {tuple(x.shape)}")
    if dt.shape != (B, S, H) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not fit x {tuple(x.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    if Bm.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("Bm and C must have x's dtype")
    for a in (dt, A, Bm, C):
        if a.device != x.device:
            raise ValueError("all operands must be on x's device")


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, C: Tensor, *,
             return_state: bool = False):
    """Chunked SSD scan (fp32 math, y in x's dtype)."""
    _check(x, dt, A, Bm, C)
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, Bm, C, chunk=CHUNK, return_state=return_state)
    return _launch(x, dt, A, Bm, C, return_state=return_state)


def _declare(lib):
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, dt, A, Bm, C, *, return_state):
    global launches
    if not all(a.is_contiguous() for a in (x, dt, A, Bm, C)):
        raise ValueError("ssd_scan kernel needs contiguous operands")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if N % 16 or not 16 <= N <= MAX_D_STATE or P % 16 or not 16 <= P <= MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan kernel takes d_state and head_dim multiples of 16 up to "
                         f"{MAX_D_STATE} and {MAX_HEAD_DIM}, got N={N}, P={P}")
    lib = _declare(_build.library())
    y = torch.empty_like(x)
    state = (torch.empty(B, H, N, P, dtype=torch.float32, device=x.device)
             if return_state else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr() if return_state else None,
            B, S, H, G, N, P, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return (y, state) if return_state else y
