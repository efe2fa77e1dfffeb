"""Port ↔ reference parity: K5, the fused EM / ancestral update
x' = c0·x + c1·score + c2·z.

The port's ``ops.em_step`` on CPU tensors runs its plain version
(``repro_torch/kernels/solver_step/ref.py::em_step``); it is held
against the reference's ``ref.py::em_step`` and against the reference's
Pallas ``em_step`` (interpret mode on the CPU) on the same numpy inputs,
including D that are not multiples of 128. The CUDA kernel itself is
held against the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). Here, on the CPU, ``ops.em_kernel_config`` (the
kernel's launch) is checked, and a model of the kernel's flat pass —
the grid's packs, each lane's row by the magic-number divide stepped
lane by lane, the coefficients loaded once a row a pack — must cover
every element once and give the plain version's bits.

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


# --- the kernel's launch and a CPU model of its flat pass -------------------

MODEL_SHAPES = [(4096, 2), (5, 3), (3, 999), (7, 1), (2, 4), (100_000, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B", [4096, 2048])
def test_em_kernel_config_tables_states_take_one_wave(B, dtype):
    """The tables' (B, 2) states: a handful of blocks, at most one a SM,
    in one pass, where the former kernel launched a block a row."""
    cfg = ops.em_kernel_config(B, 2, dtype, True)
    assert cfg["passes"] == 1 and cfg["grid"] <= ops.H100_SMS
    assert cfg["grid"] * cfg["threads"] * cfg["elems_per_thread"] >= B * 2
    assert cfg["grid"] == -(-B * 2 // (cfg["threads"] * cfg["elems_per_thread"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_em_kernel_config_streams_only_states_past_a_quarter_of_l2(dtype):
    """Evict-first loads and stores at the DiT's state, whose 4·B·D
    elements pass a quarter of the L2; plain ones at the tables' states,
    whose x' the next kernels read from the L2."""
    assert ops.em_kernel_config(8, 196_608, dtype, True)["evict_first"]
    for b in (4096, 2048, 100_000):
        assert not ops.em_kernel_config(b, 2, dtype, True)["evict_first"]
    moved = lambda b, d: 4 * b * d * dtype.itemsize
    for b, d in ((256, 3072), (64, 736), (8, 3072)):
        want = moved(b, d) > ops.EM_STREAM_BYTES
        assert ops.em_kernel_config(b, d, dtype, False)["evict_first"] == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_em_kernel_config_large_batch_is_one_dimensional(dtype):
    """B = 100,000 (above gridDim.y's 65,535) fits a 1-D grid; a state
    past a wave of blocks takes grid-stride passes instead of more blocks."""
    cfg = ops.em_kernel_config(100_000, 2, dtype, True)
    assert isinstance(cfg["grid"], int) and 0 < cfg["grid"] <= 2**31 - 1
    assert cfg["threads"] <= 1024 and cfg["magic"] > 0
    covered = cfg["grid"] * cfg["threads"] * cfg["elems_per_thread"] * cfg["passes"]
    assert covered >= 100_000 * 2
    wave = ops.H100_SMS * ops.THREADS_PER_SM // ops.EM_THREADS
    huge = ops.em_kernel_config(1 << 16, 1 << 14, dtype, True)
    assert huge["grid"] == wave and huge["passes"] > 1
    assert huge["magic"] > 0  # 2^30 elements: the magic-number divide
    assert ops.em_kernel_config(1 << 17, 1 << 14, dtype, True)["magic"] == 0  # 2^31: 64-bit


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 8, 999, 3072, 196_608])
def test_em_kernel_config_load_width_follows_alignment_alone(D, dtype, aligned):
    """16-byte loads exactly where the bases are aligned, whatever D is;
    bf16 packs hold 8 elements, fp32 4. The launch shape does not depend
    on the alignment."""
    cfg = ops.em_kernel_config(8, D, dtype, aligned)
    assert cfg["load_bytes"] == (16 if aligned else dtype.itemsize)
    assert cfg["elems_per_thread"] == {torch.float32: 4, torch.bfloat16: 8}[dtype]
    other = ops.em_kernel_config(8, D, dtype, not aligned)
    assert {k: v for k, v in cfg.items() if k != "load_bytes"} == \
        {k: v for k, v in other.items() if k != "load_bytes"}


def test_fast_divider_is_exact_below_2_31():
    """(umulhi(n, magic) + n) >> shift == n // D for every n < 2^31: at
    the ends of the range, around multiples of D, and at random points."""
    rng = np.random.default_rng(0)
    for d in (1, 2, 3, 5, 7, 736, 999, 3072, 196_608, 2**20 + 7, 2**30, 2**30 + 1,
              2**31 - 1):
        magic, shift = ops.fast_divider(d)
        assert 0 < magic < 2**32
        n = np.concatenate([rng.integers(0, 2**31, 20_000),
                            np.arange(min(4 * d + 4, 4096)),
                            np.array([d - 1, d, d + 1, 2**31 - 2, 2**31 - 1]).clip(0, 2**31 - 1)])
        n = torch.from_numpy(n.astype(np.int64))
        assert torch.equal((((n * magic) >> 32) + n) >> shift, n // d), d
    with pytest.raises(ValueError):
        ops.fast_divider(0)


def _kernel_model(x, s, z, c0, c1, c2, cfg):
    """K5 as ``em_step.cu`` runs it, on CPU tensors: (out, rows, loads).

    Every (pass, block, thread) of the launch gives a pack index,
    which must cover the packs once; a pack's first row comes from the
    magic-number divide, each further lane steps its column and moves to
    the next row when the column reaches D; a lane loads the coefficients
    where it is lane 0 or starts a row, and takes its left neighbour's
    otherwise; lanes at or past B·D are masked. The arithmetic is the
    kernel's: fp32 products and sums in the plain version's order, one
    rounding to the dtype at the store."""
    B = x.shape[0]
    n = x.numel()
    D = n // B
    N, T, G = cfg["elems_per_thread"], cfg["threads"], cfg["grid"]
    packs = -(-n // N)
    q, b, t = torch.meshgrid(torch.arange(cfg["passes"]), torch.arange(G), torch.arange(T),
                             indexing="ij")
    p = (q * G * T + b * T + t).reshape(-1)
    p = p[p < packs]
    assert torch.equal(p.sort().values, torch.arange(packs))  # each pack once
    i0 = p * N
    magic, shift = cfg["magic"], cfg["shift"]
    row = ((((i0 * magic) >> 32) + i0) >> shift) if magic else i0 // D
    col = i0 - row * D
    flat = [a.reshape(-1).float() for a in (x, s, z)]
    coeffs = (c0, c1, c2)
    out = torch.empty(n, dtype=torch.float32)
    rows = torch.empty(n, dtype=torch.int64)
    loads = 0
    held = None
    for e in range(N):
        if e > 0:
            col = col + 1
            wrap = col == D
            col = torch.where(wrap, 0, col)
            row = row + wrap.long()
        i = i0 + e
        live = i < n
        load = (col == 0) | (e == 0)
        loads += int((load & live).sum())
        fresh = torch.stack([c[row.clamp(max=B - 1)] for c in coeffs])
        held = fresh if held is None else torch.where(load, fresh, held)
        i, r, a = i[live], row[live], held[:, live]
        rows[i] = r
        out[i] = (a[0] * flat[0][i] + a[1] * flat[1][i]) + a[2] * flat[2][i]
    return out.to(x.dtype).reshape(x.shape), rows, loads


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=str)
def test_kernel_model_gives_plain_bits_and_matches_reference(shape, dtype):
    """The model of the kernel's flat pass at row widths below, at and
    above a pack (and B past 65,535): every element's row is its true
    row, the coefficients are loaded once a row a pack, the result has
    the plain version's bits, and it agrees with the reference's plain
    ``em_step`` and its interpreted Pallas kernel within this file's
    bounds."""
    jdt, tdt = DTYPES[dtype]
    B, D = shape
    states, coeffs = _inputs(shape, seed=B + D)
    ts = [torch.from_numpy(a).to(tdt) for a in states]
    tc = [torch.from_numpy(c) for c in coeffs]
    cfg = ops.em_kernel_config(B, D, tdt, True)
    out, rows, loads = _kernel_model(*ts, *tc, cfg)
    assert torch.equal(rows, torch.arange(B * D) // D)
    N = cfg["elems_per_thread"]
    first = torch.arange(-(-B * D // N)) * N
    last = torch.clamp(first + N, max=B * D) - 1
    assert loads == int((last // D - first // D + 1).sum())  # distinct rows a pack
    assert torch.equal(out, ref.em_step(*ts, *tc))
    js = [jnp.asarray(a).astype(jdt) for a in states]
    jc = [jnp.asarray(c) for c in coeffs]
    np.testing.assert_allclose(_f32(out), _f32(jref.em_step(*js, *jc)), **TOL[dtype])
    np.testing.assert_allclose(_f32(out), _f32(jops.em_step(*js, *jc)), **TOL[dtype])
