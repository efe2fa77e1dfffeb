"""Wrapper of P1, the per-row Philox normals (no reference counterpart:
the reference's per-slot draw is XLA's threefry).

``normal(seed, counter, D)`` takes (B,) int64 ``seed`` and ``counter`` and
returns z (B, D) fp32: row i is the stream of (seed_i, counter_i), 0 where
seed_i < 0 (``ref.py`` states the arithmetic). ``words`` returns the raw
uint32 words (as int64) of the same streams, the bit-exact check of the
kernel against ``ref.philox_words``.

Dispatch is by the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch ``csrc/philox_normal.cu`` or raise, with no
fallback. ``launches`` counts kernel launches (one a call). The wrapper
allocates nothing but its output and reads no value back, so a CUDA graph
can capture it; a call under capture launches nothing and counts in
``captured``, and whoever replays the graph charges ``launches`` with its
replays (``graph_loop.ops.WhileDriver``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.philox import ref

Tensor = torch.Tensor

#: kernel launches since the count was last set to 0
launches = 0
#: kernels recorded into CUDA graphs under capture (not launched)
captured = 0

#: blocks of the kernel an SM holds (256 threads each, a full SM's 2048)
_BLOCKS_PER_SM = 8


def _check(seed: Tensor, counter: Tensor, D: int) -> None:
    if seed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seed.device}")
    if seed.ndim != 1 or counter.shape != seed.shape:
        raise ValueError(f"seed {tuple(seed.shape)} and counter {tuple(counter.shape)} "
                         "must both be (B,)")
    if seed.dtype != torch.int64 or counter.dtype != torch.int64:
        raise TypeError("seed and counter must be int64")
    if counter.device != seed.device:
        raise ValueError("seed and counter must be on one device")
    if int(D) <= 0:
        raise ValueError(f"row length {D} must be positive")


def normal(seed: Tensor, counter: Tensor, D: int) -> Tensor:
    """(B, D) fp32 normals of the rows' streams."""
    _check(seed, counter, D)
    if seed.device.type == "cpu":
        return ref.philox_normal(seed, counter, D)
    return _launch(seed, counter, int(D), raw=False)


def words(seed: Tensor, counter: Tensor, D: int) -> Tensor:
    """(B, D) int64: the rows' first D uint32 words."""
    _check(seed, counter, D)
    if seed.device.type == "cpu":
        return ref.philox_words(seed, counter, D)
    w = _launch(seed, counter, int(D), raw=True)
    return w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _declare(lib):
    fn = lib.philox_normal
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(seed: Tensor, counter: Tensor, D: int, *, raw: bool) -> Tensor:
    global launches, captured
    if not (seed.is_contiguous() and counter.is_contiguous()):
        raise ValueError("philox seed and counter must be contiguous")
    lib = _declare(_build.library())
    B = seed.shape[0]
    out = torch.empty(B, D, dtype=torch.float32, device=seed.device)
    vec = D % 4 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.philox_normal(seed.data_ptr(), counter.data_ptr(), out.data_ptr(), B, D,
                               int(raw), int(vec),
                               _BLOCKS_PER_SM * _sm_count(seed.device.index), stream)
        graphed = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"philox_normal kernel launch failed: CUDA error {rc}")
    if graphed:
        captured += 1
    else:
        launches += 1
    return out
