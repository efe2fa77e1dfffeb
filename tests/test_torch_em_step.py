"""Port ↔ reference parity: K5, the fused EM / ancestral update
x' = c0·x + c1·score + c2·z.

The port's ``ops.em_step`` on CPU tensors runs its plain version
(``repro_torch/kernels/solver_step/ref.py::em_step``); it is held
against the reference's ``ref.py::em_step`` and against the reference's
Pallas ``em_step`` (interpret mode on the CPU) on the same numpy inputs,
including D that are not multiples of 128. The CUDA kernel itself is
held against the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Bounds: fp32 rtol 1e-6, atol 1e-6 — the same three products and two
sums; XLA's CPU code fuses a product and a sum into one multiply-add
where torch rounds each, so the two differ by an ulp or two. bf16: one
bf16 ulp (rtol/atol 1e-2) — both compute in fp32 and round once, and two
fp32 values an ulp apart can round to neighbouring bf16 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.solver_step import ops as jops
from repro.kernels.solver_step import ref as jref
from repro_torch.kernels.solver_step import ops
from repro_torch.kernels.solver_step import ref

torch.set_num_threads(2)

SHAPES = [(2, 16, 16, 3), (4, 17), (4, 300), (4, 1000), (8, 3072)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": dict(rtol=1e-6, atol=1e-6), "bf16": dict(rtol=1e-2, atol=1e-2)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    B = shape[0]
    states = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    coeffs = [rng.uniform(-1, 2, B).astype(np.float32) for _ in range(3)]
    return states, coeffs


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_em_step_matches_reference(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    states, coeffs = _inputs(shape)
    js = [jnp.asarray(s).astype(jdt) for s in states]
    ts = [torch.from_numpy(s).to(tdt) for s in states]
    jc, tc = [jnp.asarray(c) for c in coeffs], [torch.from_numpy(c) for c in coeffs]
    before = ops.em_launches
    out = ops.em_step(*ts, *tc)
    assert ops.em_launches == before  # CPU tensors take the plain version
    assert out.shape == shape and out.dtype == tdt
    B = shape[0]
    want_ref = jref.em_step(*(a.reshape(B, -1) for a in js), *jc)
    np.testing.assert_allclose(_f32(out).reshape(B, -1), _f32(want_ref), **TOL[dtype])
    want_kernel = jops.em_step(*js, *jc)  # the Pallas kernel, interpreted
    np.testing.assert_allclose(_f32(out), _f32(want_kernel), **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_rounds_once(dtype):
    """All math in fp32 and one rounding at the end: the bf16 result is
    the fp32 result rounded, bit for bit, and ((c0·x + c1·s) + c2·z) is
    the order of the sums."""
    _, tdt = DTYPES[dtype]
    states, coeffs = _inputs((4, 1000), seed=1)
    ts = [torch.from_numpy(s).to(tdt) for s in states]
    tc = [torch.from_numpy(c) for c in coeffs]
    wide = [t.float() for t in ts]
    c0, c1, c2 = (c[:, None] for c in tc)
    want = ((c0 * wide[0] + c1 * wide[1]) + c2 * wide[2]).to(tdt)
    assert torch.equal(ref.em_step(*ts, *tc), want)


def test_unit_coefficient_is_exact():
    """c0 = 1 leaves x untouched by its product: the Langevin corrector and
    the VE predictor round as the reference's x + c1·s + c2·z."""
    states, coeffs = _inputs((3, 50), seed=2)
    x, s, z = map(torch.from_numpy, states)
    c1, c2 = torch.from_numpy(coeffs[1]), torch.from_numpy(coeffs[2])
    got = ops.em_step(x, s, z, torch.ones(3), c1, c2)
    assert torch.equal(got, x + c1[:, None] * s + c2[:, None] * z)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    states, coeffs = _inputs((4, 96))
    ts = [torch.from_numpy(s) for s in states]
    tc = [torch.from_numpy(c) for c in coeffs]
    with pytest.raises(TypeError):
        ops.em_step(*[t.double() for t in ts], *tc)
    with pytest.raises(ValueError):  # operands of two dtypes
        ops.em_step(ts[0], ts[1].bfloat16(), ts[2], *tc)
    with pytest.raises(ValueError):  # operands of two shapes
        ops.em_step(ts[0][:, :95].contiguous(), *ts[1:], *tc)
    with pytest.raises(ValueError):  # fp64 coefficients
        ops.em_step(*ts, tc[0].double(), *tc[1:])
    with pytest.raises(ValueError):  # a coefficient per element, not per row
        ops.em_step(*ts, torch.zeros(4, 96), *tc[1:])
