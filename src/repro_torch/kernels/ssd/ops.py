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
rounding) or raise. There is no fallback from one to the other, and the
launch refuses inputs that require grad under grad mode
(``kernels.autograd``: the kernel has no backward).
``launches`` counts calls that launched the kernel: one a call, though a
call runs two or three CUDA kernels (C·Bᵀ once a group, the ranges'
local states when the sequence is split, the chunk body).

Where B·H blocks alone would leave SMs idle, the kernel splits each
(b, h) sequence into ``ranges`` ranges of whole chunks, so that
B·H·ranges blocks fill the card; ``choose_ranges`` picks
the count from B·H, the chunk count and the card's SMs and resident
blocks, so the same shape on the same card runs the same count and gives
the same bits. ``ref.ssd_ranges`` is the same decomposition in plain
PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import refuse_autograd
from repro_torch.kernels.ssd import ref

Tensor = torch.Tensor

#: kernel launches since the count was last set to 0
launches = 0

#: the plain version's chunk (the reference's DEFAULT_CHUNK)
CHUNK = 128
#: the kernel's chunk: 64 rows keep the quadratic part (the masked scores
#: times x) at a quarter of the update's multiply-adds, and the block's
#: shared memory (x split, C, the state) at 108 KB, two blocks an SM
KERNEL_CHUNK = 64
#: the range-count model: a chunk of pass 1 (the update product alone)
#: against a chunk of the body, and the combine of one earlier range's
#: state against a chunk of the body
STATE_PASS_COST, COMBINE_COST = 0.5, 0.1
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


@functools.cache
def choose_ranges(bh: int, nc: int, sms: int, chunks_per_sm: int,
                  states_per_sm: int) -> int:
    """Ranges per (b, h) sequence: 1 when the B·H blocks fill a wave of
    the body's slots already (a split then adds pass 1 and its scratch
    and buys nothing measured); else the count in [1, nc] of least
    modelled time, waves of the body × (its chunks + the combine) + waves
    of pass 1 × its chunks; the smallest count on a tie. A function of
    the shape and the card only (cached: the search is linear in nc, and
    every layer of a prefill asks for the same shape)."""
    slots, state_slots = sms * chunks_per_sm, sms * states_per_sm
    if bh >= slots:
        return 1

    def cost(r):
        per = -(-nc // r)
        body = -(-bh * r // slots) * (per + COMBINE_COST * (r - 1))
        return body + (STATE_PASS_COST * -(-bh * (r - 1) // state_slots) * per if r > 1 else 0)

    return min(range(1, nc + 1), key=lambda r: (cost(r), r))


def check_alignment(x: Tensor, Bm: Tensor, C: Tensor) -> None:
    """Raise unless x, Bm and C start on 16 bytes, as the kernel's 16-byte
    (fp32) and 8-byte (bf16) row loads need; with contiguous operands and
    head_dim and d_state multiples of 16, every row then starts on 16
    bytes too. A contiguous view into a larger buffer may not."""
    for name, t in (("x", x), ("Bm", Bm), ("C", C)):
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan kernel needs a 16-byte-aligned {name}: "
                             f"data_ptr % 16 = {t.data_ptr() % 16}")


def _declare(lib):
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        cfg = lib.ssd_scan_config
        cfg.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5
        cfg.restype = ctypes.c_int
    return lib


@functools.cache
def kernel_config(device_index: int, dtype_code: int) -> dict:
    """The kernel's launch facts on one card: its SMs, the blocks of the
    chunk body and of pass 1 an SM holds, and each kernel's dynamic shared
    memory in bytes."""
    lib = _declare(_build.library())
    vals = [ctypes.c_int() for _ in range(5)]
    with torch.cuda.device(device_index):
        rc = lib.ssd_scan_config(dtype_code, *(ctypes.byref(v) for v in vals))
    if rc != 0 or min(vals[0].value, vals[1].value) < 1:
        raise RuntimeError(f"ssd_scan kernel configuration failed: CUDA error {rc}")
    return dict(sms=torch.cuda.get_device_properties(device_index).multi_processor_count,
                chunks_per_sm=vals[0].value, states_per_sm=vals[1].value,
                smem_cb=vals[2].value, smem_states=vals[3].value, smem_chunks=vals[4].value)


def ranges_for(x: Tensor) -> int:
    """The range count ``ssd_scan`` runs for x (B, S, H, P) on x's card."""
    B, S, H, _ = x.shape
    c = kernel_config(x.device.index if x.device.index is not None
                      else torch.cuda.current_device(), _DTYPES[x.dtype])
    return choose_ranges(B * H, -(-S // KERNEL_CHUNK), c["sms"], c["chunks_per_sm"],
                         c["states_per_sm"])


def _launch(x, dt, A, Bm, C, *, return_state, ranges=None):
    """The kernel on CUDA tensors; ``ranges`` overrides the range count
    (tests compare counts; the main path never passes it)."""
    global launches
    refuse_autograd("ssd_scan", x, dt, A, Bm, C)
    if not all(a.is_contiguous() for a in (x, dt, A, Bm, C)):
        raise ValueError("ssd_scan kernel needs contiguous operands")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if N % 16 or not 16 <= N <= MAX_D_STATE or P % 16 or not 16 <= P <= MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan kernel takes d_state and head_dim multiples of 16 up to "
                         f"{MAX_D_STATE} and {MAX_HEAD_DIM}, got N={N}, P={P}")
    check_alignment(x, Bm, C)
    lib = _declare(_build.library())
    nc = -(-S // KERNEL_CHUNK)
    R = ranges_for(x) if ranges is None else ranges
    if not 1 <= R <= nc:
        raise ValueError(f"ranges must be in [1, {nc}], got {R}")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    state = torch.empty(B, H, N, P, **f32) if return_state else None
    cb = torch.empty(B * nc * G * KERNEL_CHUNK * KERNEL_CHUNK, **f32)
    local = torch.empty(B * H * (R - 1) * MAX_D_STATE * MAX_HEAD_DIM, **f32) if R > 1 else None
    decay = torch.empty(B * H * (R - 1), **f32) if R > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr() if return_state else None, cb.data_ptr(),
            local.data_ptr() if R > 1 else None, decay.data_ptr() if R > 1 else None,
            B, S, H, G, N, P, R, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return (y, state) if return_state else y
