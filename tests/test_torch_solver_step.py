"""Port ↔ reference parity: the fused solver step.

The port's ``ops.error_step`` on CPU tensors runs its plain version
(``repro_torch/kernels/solver_step/ref.py``); it is held against the
reference's ``ref.py`` on the same numpy inputs in every case, and
against the reference's Pallas kernel (interpret mode on the CPU) with
``use_prev`` on. The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Bounds: fp32 rtol 1e-5 / atol 1e-6 — same fp32 arithmetic, the row sum
taken in another order. bf16 1e-2 on x'' — one bf16 rounding of the
same fp32 value can land one bf16 ulp apart; e2 is fp32 from identical
bf16 inputs, so it keeps the fp32 bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.solver_step import ops as jops
from repro.kernels.solver_step import ref as jref
from repro_torch.kernels.solver_step import ops

torch.set_num_threads(2)

SHAPES = [(2, 16, 16, 3), (4, 17), (4, 96), (4, 300), (4, 3072)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
X_TOL = {"fp32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=1e-2, atol=1e-2)}
E_TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    B = shape[0]
    states = [rng.standard_normal(shape).astype(np.float32) for _ in range(5)]
    coeffs = [rng.uniform(0, 1, B).astype(np.float32) for _ in range(3)]
    eps = (rng.uniform(1e-3, 0.1, B).astype(np.float32),
           rng.uniform(0.01, 0.5, B).astype(np.float32))
    return states, coeffs, eps


def _reference_kernel_tiles(D: int) -> bool:
    """Whether the reference kernel's 512-wide D blocks tile its
    128-padded D. Where they do not (D = 768 here), its last block reads
    past the padded array and its e2 is not defined; see
    ``test_reference_kernel_reads_past_padded_d``."""
    d_pad = -(-D // 128) * 128
    return d_pad % min(512, d_pad) == 0


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("use_prev", [True, False], ids=["prev", "noprev"])
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_error_step_matches_reference(shape, dtype, vector, use_prev):
    jdt, tdt = DTYPES[dtype]
    states, coeffs, (ea, er) = _inputs(shape)
    js = [jnp.asarray(s).astype(jdt) for s in states]
    ts = [torch.from_numpy(s).to(tdt) for s in states]
    jc = [jnp.asarray(c) for c in coeffs]
    tc = [torch.from_numpy(c) for c in coeffs]
    if vector:
        jkw = dict(eps_abs=jnp.asarray(ea), eps_rel=jnp.asarray(er))
        tkw = dict(eps_abs=torch.from_numpy(ea), eps_rel=torch.from_numpy(er))
    else:
        jkw = tkw = dict(eps_abs=0.0078, eps_rel=0.05)
    xh, e2 = ops.error_step(*ts, *tc, use_prev=use_prev, **tkw)
    assert xh.shape == shape and xh.dtype == tdt and e2.dtype == torch.float32
    if use_prev:  # the solver's default; the interpreted kernel is slow
        jxh, je2 = jops.error_step(*js, *jc, use_prev=use_prev, **jkw)
        np.testing.assert_allclose(_f32(xh), _f32(jxh), **X_TOL[dtype])
        if _reference_kernel_tiles(int(np.prod(shape[1:]))):
            np.testing.assert_allclose(e2.numpy(), _f32(je2), **E_TOL)
    B = shape[0]
    flat = [a.reshape(B, -1) for a in js]
    rxh, re2 = jref.error_step(*flat, *jc, use_prev=use_prev, **jkw)
    np.testing.assert_allclose(_f32(xh).reshape(B, -1), _f32(rxh), **X_TOL[dtype])
    np.testing.assert_allclose(e2.numpy(), _f32(re2), **E_TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uniform_vector_is_scalar_bitwise(dtype):
    """A uniform (B,) tolerance gives the scalar path's bits: the scalar
    is broadcast into the same (B,) operand."""
    _, tdt = DTYPES[dtype]
    states, coeffs, _ = _inputs((8, 3072), seed=5)
    ts = [torch.from_numpy(s).to(tdt) for s in states]
    tc = [torch.from_numpy(c) for c in coeffs]
    a = ops.error_step(*ts, *tc, eps_abs=0.0078, eps_rel=0.05)
    b = ops.error_step(*ts, *tc, eps_abs=torch.full((8,), 0.0078),
                       eps_rel=torch.full((8,), 0.05))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    states, coeffs, _ = _inputs((4, 96))
    ts = [torch.from_numpy(s) for s in states]
    tc = [torch.from_numpy(c) for c in coeffs]
    kw = dict(eps_abs=0.0078, eps_rel=0.05)
    with pytest.raises(TypeError):
        ops.error_step(*[t.double() for t in ts], *tc, **kw)
    with pytest.raises(ValueError):
        ops.error_step(ts[0][:, :95].contiguous(), *ts[1:], *tc, **kw)
    with pytest.raises(ValueError):
        ops.error_step(*ts, tc[0].double(), *tc[1:], **kw)
    with pytest.raises(ValueError):
        ops.error_step(*ts, *tc, eps_abs=torch.zeros(3), eps_rel=0.05)


def test_reference_kernel_reads_past_padded_d():
    """A reference fault the port exposes: at D = 768 (a 16×16×3 image)
    the reference pads D to 768 but tiles it in 512-wide blocks, so its
    second block reads columns 768..1023, which do not exist; interpret
    mode fills them with NaN and e2 comes back NaN. The port masks the
    ragged tile and agrees with the reference's own ``ref.py`` there."""
    shape = (2, 16, 16, 3)
    states, coeffs, _ = _inputs(shape)
    kw = dict(eps_abs=0.0078, eps_rel=0.05)
    _, je2 = jops.error_step(*map(jnp.asarray, states), *map(jnp.asarray, coeffs), **kw)
    assert not _reference_kernel_tiles(768)
    assert np.isnan(np.asarray(je2)).all()
    _, e2 = ops.error_step(*map(torch.from_numpy, states),
                           *map(torch.from_numpy, coeffs), **kw)
    _, re2 = jref.error_step(*(jnp.asarray(s).reshape(2, -1) for s in states),
                             *map(jnp.asarray, coeffs), **kw)
    np.testing.assert_allclose(e2.numpy(), np.asarray(re2), **E_TOL)


def test_kernel_config_planning_row_is_one_block():
    """Planning's state (64 plans of 32 × 23) fits one 3072-column tile a
    row: one block a row writes e2 itself, with 16-byte loads in fp32 and
    8-byte in bf16."""
    for tdt in (torch.float32, torch.bfloat16):
        cfg = ops.kernel_config(64, 736, 736, tdt, True)
        assert (cfg["tiles"], cfg["grid"], cfg["design"]) == (1, (1, 64), "one block a row")
        assert cfg["load_bytes"] == 4 * tdt.itemsize


def test_kernel_config_dit_row_is_last_block_of_a_row():
    cfg = ops.kernel_config(8, 196_608, 196_608, torch.float32, True)
    assert (cfg["tiles"], cfg["grid"], cfg["design"]) == (64, (64, 8), "last block of a row")
    assert cfg["load_bytes"] == 16 and cfg["threads"] == ops.STEP_THREADS
    assert ops.STEP_TILE == ops.STEP_THREADS * 3 * ops.STEP_VEC


def test_kernel_config_unaligned_k4_range_loads_single_elements():
    """K4 reads column ranges in place; a range of the ragged state D = 4999
    split four ways starts at column 1250, 5000 bytes into a row, and its
    rows are 4999 columns apart: the launch takes single-element loads,
    which are legal at any column. An aligned range keeps 16 bytes."""
    D, f = 4999, 4
    state = torch.zeros(8, D)
    for i in range(f):
        a, b = ops.feature_range(D, f, i)
        block = state[:, a:b]
        cfg = ops.kernel_config(8, b - a, block.stride(0), torch.float32,
                                ops.runs_aligned([block]))
        assert cfg["load_bytes"] == 4
    wide = torch.zeros(8, 196_608)
    for i in range(4):
        a, b = ops.feature_range(196_608, 4, i)
        block = wide[:, a:b]
        aligned = ops.runs_aligned([block])
        cfg = ops.kernel_config(8, b - a, block.stride(0), torch.float32, aligned)
        assert aligned == (wide.data_ptr() % 16 == 0) and cfg["load_bytes"] in (4, 16)
    odd = wide[:, 1:4097]  # 4 bytes off the row's start
    assert not ops.runs_aligned([odd])
    assert ops.kernel_config(8, 4096, 196_608, torch.float32, False)["load_bytes"] == 4
    assert ops.kernel_config(8, 4096, 4097, torch.float32, True)["load_bytes"] == 4
    assert ops.kernel_config(8, 4097, 4100, torch.float32, True)["load_bytes"] == 4


@pytest.mark.parametrize("D", [1, 736, 2048, 3072, 3073, 4_999, 98_304, 196_608])
def test_kernel_config_row_order_never_depends_on_b(D):
    """The tiling, which fixes a row's order of summation, is a function
    of D alone: every batch, row stride, dtype and alignment gives the
    same tiles and design."""
    seen = {(c["tiles"], c["design"], c["threads"])
            for B in (1, 2, 7, 8, 64, 65_535)
            for ld in (D, D + 1, 2 * D)
            for tdt in (torch.float32, torch.bfloat16)
            for aligned in (False, True)
            for c in [ops.kernel_config(B, D, ld, tdt, aligned)]}
    assert seen == {(-(-D // ops.STEP_TILE),
                     "one block a row" if D <= ops.STEP_TILE else "last block of a row",
                     ops.STEP_THREADS)}


@pytest.mark.parametrize("B", [1, 8, 4096, 65_535, 65_536, 70_000, 200_000])
def test_kernel_config_row_ranges_cover_every_row_once(B):
    """Rows sit on ``gridDim.y``, so one launch takes at most 65,535: the
    wrapper launches a larger batch in consecutive ranges (each on its
    rows' slices, the tiling unchanged), which cover every row exactly
    once; up to 65,535 rows it is today's single launch of all B."""
    for D in (2, 736, 196_608):
        cfg = ops.kernel_config(B, D, D, torch.float32, True)
        rows = [r for r0, n in cfg["ranges"] for r in range(r0, r0 + n)]
        assert rows == list(range(B))
        assert all(0 < n <= ops.MAX_GRID_ROWS for _, n in cfg["ranges"])
        assert cfg["tiles"] == -(-D // ops.STEP_TILE)
        if B <= ops.MAX_GRID_ROWS:
            assert cfg["ranges"] == [(0, B)] and cfg["grid"] == (cfg["tiles"], B)
        else:
            assert len(cfg["ranges"]) == -(-B // ops.MAX_GRID_ROWS)
