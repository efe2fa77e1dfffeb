"""Wrapper of the flash-attention kernel; port of
``repro/kernels/flash_attention/ops.py``.

``attention(q, k, v)`` takes q (B, Hq, S, D) and k/v (B, Hkv, S, D) with
any strides whose last dimension is contiguous, so a transposed view of
the model's (B, S, H, D) projections goes in without a copy; the output
has q's layout. The kernel masks any S itself, so unlike the reference
wrapper nothing is padded.

Dispatch is by the device of the tensors: CPU tensors take the plain
version (``ref.attention``); CUDA tensors launch
``csrc/flash_attention.cu`` or raise. There is no fallback from one to
the other, and the launch refuses inputs that require grad under grad
mode (``kernels.autograd``: the kernel has no backward). The kernel moves K/V tiles 16 bytes at a time
(``cp.async``), so on the card q, k and v need 16-byte-aligned base
pointers and (b, h, s) strides (``check_alignment``): every model
tensor of fp32 or bf16 rows whose head width is a multiple of 4 (fp32)
or 8 (bf16) has them. ``launches`` counts kernel launches: one a call
up to 65,535 (b, h) pairs, else one a range of whole batches
(``batch_ranges``; the pairs sit on ``gridDim.y``). A call made while
the stream is captured into a CUDA graph launches nothing: it counts in
``captured``, and whoever replays the graph charges ``launches`` with
its replays (``graph_loop.ops.WhileDriver``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import refuse_autograd
from repro_torch.kernels.flash_attention import ref

Tensor = torch.Tensor

#: kernel launches since the count was last set to 0
launches = 0
#: kernels recorded into CUDA graphs under capture (not launched)
captured = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: (b, h) pairs one launch takes (they sit on ``gridDim.y``)
MAX_GRID_HEADS = 65535


def batch_ranges(B: int, Hq: int) -> list:
    """The (first batch, batches) of each launch: one launch of all B
    where B·Hq ≤ ``MAX_GRID_HEADS``, else consecutive ranges of whole
    batches, each of at most that many (b, h) pairs."""
    per = MAX_GRID_HEADS // Hq
    if per < 1:
        raise ValueError(f"{Hq} query heads exceed the kernel's {MAX_GRID_HEADS} a launch")
    return [(b, min(per, B - b)) for b in range(0, B, per)]


def _check(q, k, v, window, true_len):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {k.shape[1]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes must match and be one of {list(_DTYPES)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if true_len is not None and not 1 <= true_len <= S:
        raise ValueError(f"true_len {true_len} outside [1, {S}]")


def _aligned(t: Tensor) -> bool:
    n = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st % n == 0 for st, size in zip(t.stride()[:3], t.shape[:3]) if size > 1)


def check_alignment(q: Tensor, k: Tensor, v: Tensor) -> None:
    """Raise unless each of q, k, v starts on 16 bytes and steps over
    batch, head and position by whole 16-byte units, as the kernel's
    16-byte copies need. Dims of size 1 are never stepped over."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            raise ValueError(
                f"flash attention needs 16-byte-aligned {name}: data_ptr % 16 = "
                f"{t.data_ptr() % 16}, (b, h, s) strides {tuple(t.stride()[:3])} in "
                f"{t.dtype} elements must be multiples of {16 // t.element_size()}")


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: int | None = None, scale: float | None = None,
              true_len: int | None = None) -> Tensor:
    _check(q, k, v, window, true_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale, true_len=true_len)
    return _launch(q, k, v, causal=causal, window=window, scale=scale,
                   true_len=true_len)


def _declare(lib):
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, *, causal, window, scale, true_len):
    global launches, captured
    refuse_autograd("flash_attention", q, k, v)
    if any(a.stride(-1) != 1 for a in (q, k, v)):
        raise ValueError("flash attention needs a contiguous last dimension")
    check_alignment(q, k, v)
    B, Hq, S, D = q.shape
    lib = _declare(_build.library())
    out = torch.empty_like(q)  # keeps q's (b, h, s) layout
    if not _aligned(out):
        # q is a non-dense view whose head width is not a whole number of
        # 16-byte units: the output gets padded rows
        n = 16 // q.element_size()
        out = q.new_empty(B, Hq, S, -(-D // n) * n)[..., :D]
    strides = [s for a in (q, k, v, out) for s in a.stride()[:3]]
    size = q.element_size()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0, nb in batch_ranges(B, Hq):
            # a range is its batches' slice of q, k, v and out (whole
            # 16-byte units: the batch strides are checked above)
            ptrs = [a.data_ptr() + b0 * a.stride(0) * size for a in (q, k, v, out)]
            rc = lib.flash_attention_fwd(
                *ptrs, *strides, nb, Hq, k.shape[1], S, D,
                S if true_len is None else true_len, int(causal),
                0 if window is None else int(window), float(scale),
                _DTYPES[q.dtype], stream)
            if rc != 0:
                raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
            if torch.cuda.is_current_stream_capturing():
                captured += 1
            else:
                launches += 1
    return out
