"""Wrappers of the solver-step kernels; port of
``repro/kernels/solver_step/ops.py`` (``em_step``, and ``error_step``,
which dispatches to ``error_step`` or ``error_step_vec`` in the
reference).

``em_step`` (K5) takes any (B, ...) state and three (B,) fp32
coefficients, flattens the state to (B, D) and returns
x' = c0·x + c1·score + c2·z with x's shape and dtype. Its kernel makes
one flat pass over the B·D elements on a 1-D grid, fixed before the
launch by ``em_kernel_config``: 16-byte packs where every state base is
aligned, single elements where one is not, any B.

``error_step`` takes any (B, ...) state, flattens it to (B, D) and
returns (x'' with x's shape, e2 (B,) fp32). The tolerances may be floats
or (B,) tensors; floats are broadcast into (B,) fp32 tensors, so the
scalar and the per-sample form are one code path and a uniform vector
gives the scalar path's bits by construction.

``sharded_error_step`` (K4) is the step of one rank of a mesh, with the
reference's signature: the operands are the rank's rows (its batch
shard, every column). Batch-only, the rank runs the K1 kernel on its
rows, which gives the unsharded step's bits for those rows; no
collective is needed. With ``feature_axis`` the rank takes its
contiguous range of the flattened columns (``feature_range``, in place,
through a row stride), the kernel's partial mode returns its rows' raw
sums of squared scaled residuals, and one all-reduce over the feature
axis's group gives e2 = sqrt(Σ / D) (``scaled_error_l2_psum``).

Dispatch is by the device of the tensors: CPU tensors take the plain
versions (``ref.em_step``, ``ref.error_step``, ``ref.error_step_sums``);
CUDA tensors launch ``csrc/em_step.cu`` or ``csrc/solver_step.cu``, or
raise. There is no fallback from one to the other, and both launches
refuse inputs that require grad under grad mode (``kernels.autograd``:
neither kernel has a backward). ``em_launches``
counts K5's launches, ``launches`` those of K1/K2, ``sharded_launches``
those of K4 (the same kernel, launched by ``sharded_error_step``); a
call of K5 is one kernel launch, and so is a call of K1/K2/K4 up to
65,535 rows (above that, one launch a range of rows). A call made while
the stream is captured into a CUDA graph launches nothing: it counts in
``captured`` (K4's in ``captured_sharded``, K5's in ``captured_em``),
and whoever replays the graph charges ``launches`` (``sharded_launches``,
``em_launches``) with its replays (``graph_loop.ops.WhileDriver``).
``kernel_config``
fixes K1's tiling (from D alone), its ranges of rows (from B) and its
load width (from the alignment), ``em_kernel_config`` K5's grid and load
width.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import refuse_autograd
from repro_torch.kernels.solver_step import ref

Tensor = torch.Tensor

#: error_step (K1/K2) kernel launches since the count was last set to 0
launches = 0
#: em_step (K5) kernel launches since the count was last set to 0
em_launches = 0
#: sharded_error_step (K4) kernel launches since the count was last set to 0
sharded_launches = 0
#: K1/K2 kernels recorded into CUDA graphs under capture (not launched)
captured = 0
#: K4 kernels recorded into CUDA graphs under capture (not launched)
captured_sharded = 0
#: K5 kernels recorded into CUDA graphs under capture (not launched)
captured_em = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows one K1/K2/K4 launch takes (its rows sit on ``gridDim.y``)
MAX_GRID_ROWS = 65535
#: the K1/K2/K4 kernel's tiling (``kThreads``, ``kVec``, ``kTile`` in
#: ``csrc/solver_step.cu``): a block of 256 threads takes 3072 columns of a
#: row, a thread three runs of 4 consecutive columns
STEP_THREADS, STEP_VEC, STEP_TILE = 256, 4, 3072


def kernel_config(B: int, D: int, ld: int, dtype, aligned: bool) -> dict:
    """The K1/K2/K4 launch for B rows of D columns whose rows start ``ld``
    elements apart in ``dtype``; ``aligned`` says that every operand's
    base, x'' included, starts on a run of 4 elements (16 bytes in fp32,
    8 in bf16).

    Returns ``tiles`` of ``STEP_TILE`` columns a row, the ``grid``
    (tiles, rows) and ``threads`` of a launch, ``ranges``, the (first row,
    rows) of each launch: one launch of all B rows where B ≤
    ``MAX_GRID_ROWS``, else consecutive ranges of at most that many rows
    (rows sit on ``gridDim.y``), ``design`` ("one block a row" where a row
    fits one tile, whose block writes e2 itself; else "last block of a
    row", which sums the row's tile sums in tile order), and
    ``load_bytes``, the width of one load: a run of 4 elements where
    every row of every operand is aligned for it, else one element. The
    tiling, and so each row's order of summation, depends on D alone: B,
    ``ld``, the dtype and the alignment change the grid and the load
    width, never the bits."""
    size = dtype.itemsize
    tiles = -(-D // STEP_TILE)
    vec = aligned and D % STEP_VEC == 0 and ld % STEP_VEC == 0
    ranges = [(r, min(MAX_GRID_ROWS, B - r)) for r in range(0, B, MAX_GRID_ROWS)]
    return dict(tiles=tiles, grid=(tiles, ranges[0][1]), threads=STEP_THREADS,
                ranges=ranges,
                design="one block a row" if tiles == 1 else "last block of a row",
                load_bytes=STEP_VEC * size if vec else size)


#: K5's block (``em_step.cu`` takes up to 128), the threads an SM holds
#: at full occupancy, and the SMs of an H100 SXM (the config's default;
#: the wrapper passes the card's own count)
EM_THREADS, THREADS_PER_SM, H100_SMS = 128, 2048, 132
#: K5's pack: the bytes of one vector load or store
EM_PACK_BYTES = 16
#: K5 streams its state (evict-first loads and stores) where a call moves
#: more than a quarter of the H100's 50 MB L2: below that, the caller's
#: next kernels find x' (and the next step its inputs) in the L2
EM_STREAM_BYTES = 50e6 / 4


def fast_divider(d: int) -> tuple:
    """(magic, shift) with n // d == (umulhi(n, magic) + n) >> shift for
    every 0 <= n < 2^31, umulhi the high 32 bits of the 64-bit product of
    two 32-bit unsigned values: K5's row of a flat index."""
    if not 0 < d < 2**31:
        raise ValueError(f"divisor {d} outside 1..2^31-1")
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def em_kernel_config(B: int, D: int, dtype, aligned: bool, sms: int = H100_SMS) -> dict:
    """The K5 launch for a contiguous (B, D) state of ``dtype`` on a card
    of ``sms`` SMs; ``aligned`` says that x, score, z and the output all
    start on 16 bytes.

    The kernel walks the n = B·D elements flat, a thread one pack of
    ``elems_per_thread`` elements (16 bytes) a pass: one 16-byte
    load an operand where ``aligned`` (``load_bytes`` 16), else one
    element a load (``load_bytes`` the element size), with the same bits.
    ``grid`` is the blocks of ``threads`` that cover the packs, at most
    one wave (``sms`` · ``THREADS_PER_SM`` / ``threads``), and ``passes``
    the grid-stride passes. (``magic``, ``shift``) divide a flat index by
    D (``fast_divider``) while n < 2^31; magic 0 asks for a 64-bit
    division. ``evict_first``: streaming state loads and stores, where
    the call moves more than ``EM_STREAM_BYTES``."""
    size = dtype.itemsize
    pack = EM_PACK_BYTES // size
    n = B * D
    blocks = -(-n // (pack * EM_THREADS))
    grid = min(blocks, sms * (THREADS_PER_SM // EM_THREADS))
    magic, shift = fast_divider(D) if n < 2**31 else (0, 0)
    return dict(grid=grid, threads=EM_THREADS, elems_per_thread=pack,
                load_bytes=EM_PACK_BYTES if aligned else size,
                passes=-(-blocks // grid), magic=magic, shift=shift,
                evict_first=4 * n * size > EM_STREAM_BYTES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def runs_aligned(tensors) -> bool:
    """Whether every tensor starts on a run of ``STEP_VEC`` elements (16
    bytes in fp32, 8 in bf16): the ``aligned`` of ``kernel_config``."""
    return all(t.data_ptr() % (STEP_VEC * t.element_size()) == 0 for t in tensors)


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


def _step(states, e0, d1, d2, eps_abs, eps_rel, use_prev, *, raw, k4):
    """The step on (B, D) operands: the plain version for CPU tensors, else
    the kernel (``raw``: its partial mode; ``k4``: counted as K4's)."""
    B = states[0].shape[0]
    ea = per_sample_tolerance(eps_abs, B, states[0].device)
    er = per_sample_tolerance(eps_rel, B, states[0].device)
    _check(states, (e0, d1, d2, ea, er))
    if states[0].device.type == "cpu":
        plain = ref.error_step_sums if raw else ref.error_step
        return plain(*states, e0, d1, d2, ea, er, use_prev=use_prev)
    return _launch(*states, e0, d1, d2, ea, er, use_prev=use_prev, raw=raw, k4=k4)


def error_step(x, x_prime, score2, z, x_prev, e0, d1, d2, *, eps_abs,
               eps_rel, use_prev: bool = True):
    """Fused x̃ / x'' / δ / scaled-ℓ2 error. Returns (x'', e2)."""
    B = x.shape[0]
    flat = [a.reshape(B, -1) for a in (x, x_prime, score2, z, x_prev)]
    xh, e2 = _step(flat, e0, d1, d2, eps_abs, eps_rel, use_prev, raw=False, k4=False)
    return xh.reshape(x.shape), e2


def error_step_sums(x, x_prime, score2, z, x_prev, e0, d1, d2, *, eps_abs,
                    eps_rel, use_prev: bool = True):
    """K4's per-rank partial on (B, D) blocks, which may be column views of
    a wider state (inner stride 1, one row stride for all five). Returns
    (x'' (B, D) contiguous, Σ r² (B,) fp32)."""
    return _step((x, x_prime, score2, z, x_prev), e0, d1, d2, eps_abs, eps_rel,
                 use_prev, raw=True, k4=True)


def feature_range(D: int, n: int, i: int) -> tuple:
    """Columns [start, stop) of shard ``i`` of ``n`` over a flattened width
    ``D``: contiguous ranges of ceil(D / n), the last one ragged (or
    empty, where D is small)."""
    per = -(-D // n)
    return min(i * per, D), min((i + 1) * per, D)


def sharded_error_step(x, x_prime, score2, z, x_prev, e0, d1, d2, *, eps_abs,
                       eps_rel, mesh, batch_axes, feature_axis=None,
                       use_prev: bool = True):
    """``error_step`` on one rank of ``mesh`` (K4).

    The operands are this rank's rows (B_local, ...) of every column, the
    coefficients and any (B,) tolerances its (B_local,) rows: the batch
    is already split over ``batch_axes`` by the caller's sharding.
    Returns (x'', e2 (B_local,)). Batch-only, x'' has x's shape. With
    ``feature_axis``, x'' is this rank's (B_local, D_local) block of the
    flattened state, columns ``feature_range(D, f, coord)``, and e2 is
    the error over all D columns, combined across the feature axis's
    ranks with one all-reduce.
    """
    from repro_torch.parallel.collectives import scaled_error_l2_psum

    batch_axes = (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes)
    for a in batch_axes + ((feature_axis,) if feature_axis else ()):
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not in the mesh {mesh.axis_names}")
    B = x.shape[0]
    flat = [a.reshape(B, -1) for a in (x, x_prime, score2, z, x_prev)]
    if feature_axis is None:
        xh, e2 = _step(flat, e0, d1, d2, eps_abs, eps_rel, use_prev, raw=False, k4=True)
        return xh.reshape(x.shape), e2
    D = flat[0].shape[1]
    start, stop = feature_range(D, mesh.shape[feature_axis], mesh.coord(feature_axis))
    if stop > start:
        xh, sums = error_step_sums(*(a[:, start:stop] for a in flat), e0, d1, d2,
                                   eps_abs=eps_abs, eps_rel=eps_rel, use_prev=use_prev)
    else:
        xh = flat[0].new_empty(B, 0)
        sums = torch.zeros(B, dtype=torch.float32, device=x.device)
    return xh, scaled_error_l2_psum(sums, stop - start, mesh.group(feature_axis))


def _declare(lib):
    fn = lib.solver_step_error
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.solver_step_error_sums.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 4
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.solver_step_error_sums.restype = ctypes.c_int
        lib.solver_step_em.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
                                       + [ctypes.c_uint] + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
        lib.solver_step_em.restype = ctypes.c_int
    return lib


def _launch_em(x, s, z, c0, c1, c2):
    global em_launches, captured_em
    states = (x, s, z)
    refuse_autograd("em_step", *states, c0, c1, c2)
    if not all(a.is_contiguous() for a in states + (c0, c1, c2)):
        raise ValueError("em_step kernel operands must be contiguous")
    B, n = x.shape[0], x.numel()
    if n == 0:
        raise ValueError("em_step kernel needs a non-empty state")
    lib = _declare(_build.library())
    out = torch.empty_like(x)
    aligned = all(a.data_ptr() % EM_PACK_BYTES == 0 for a in states + (out,))
    cfg = em_kernel_config(B, n // B, x.dtype, aligned, _sm_count(x.device.index))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.solver_step_em(*(a.data_ptr() for a in (x, s, z, c0, c1, c2)),
                                out.data_ptr(), n, n // B, cfg["magic"], cfg["shift"],
                                cfg["grid"], cfg["threads"], int(aligned),
                                int(cfg["evict_first"]), _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"em_step kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        captured_em += 1
    else:
        em_launches += 1
    return out


def _launch(x, xp, s2, z, xv, e0, d1, d2, ea, er, *, use_prev, raw=False, k4=False):
    """Launch K1 on (B, D) operands, or with ``raw`` its partial mode on
    (B, D) blocks that share one row stride (K4's per-rank body). The
    launch counts in ``sharded_launches`` with ``k4``, else in
    ``launches``."""
    global launches, sharded_launches, captured, captured_sharded
    states = (x, xp, s2, z, xv)
    refuse_autograd("solver_step", *states, e0, d1, d2, ea, er)
    B, D = x.shape
    if raw:
        ld = x.stride(0) if B > 1 else D
        if not all(a.stride(1) == 1 and (B == 1 or a.stride(0) == ld) for a in states):
            raise ValueError("solver_step kernel blocks must have unit inner stride "
                             "and one row stride")
    elif not all(a.is_contiguous() for a in states):
        raise ValueError("solver_step kernel operands must be contiguous")
    if not all(c.is_contiguous() for c in (e0, d1, d2, ea, er)):
        raise ValueError("solver_step kernel coefficients must be contiguous")
    lib = _declare(_build.library())
    xh = torch.empty(B, D, dtype=x.dtype, device=x.device)
    e2 = torch.empty(B, dtype=torch.float32, device=x.device)
    ld_in = ld if raw else D
    cfg = kernel_config(B, D, ld_in, x.dtype, runs_aligned(states + (xh,)))
    # the tile sums of a row of many tiles; a row of one tile needs none
    partial = (torch.empty(B, cfg["tiles"], dtype=torch.float32, device=x.device)
               if cfg["tiles"] > 1 else None)
    flags = (_DTYPES[x.dtype], int(use_prev), int(cfg["load_bytes"] > x.element_size()))
    size = x.element_size()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0, rows in cfg["ranges"]:
            # a range is its rows' slice of every operand; its launch takes
            # the rows' tickets from the start of the ticket array, which
            # the launch before it, on the same stream, has set back to 0
            args = ([a.data_ptr() + r0 * ld_in * size for a in states]
                    + [c.data_ptr() + r0 * 4 for c in (e0, d1, d2, ea, er)]
                    + [xh.data_ptr() + r0 * D * size, e2.data_ptr() + r0 * 4,
                       partial.data_ptr() + r0 * cfg["tiles"] * 4
                       if partial is not None else None])
            if raw:
                rc = lib.solver_step_error_sums(*args, rows, D, ld_in, D, *flags, stream)
            else:
                rc = lib.solver_step_error(*args, rows, D, *flags, stream)
            if rc != 0:
                raise RuntimeError(f"solver_step kernel launch failed: CUDA error {rc}")
            if torch.cuda.is_current_stream_capturing():
                if k4:
                    captured_sharded += 1
                else:
                    captured += 1
            elif k4:
                sharded_launches += 1
            else:
                launches += 1
    return xh, e2
