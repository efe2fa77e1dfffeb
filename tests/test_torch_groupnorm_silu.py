"""Port ↔ reference parity: fused GroupNorm → SiLU
(``repro_torch.kernels.groupnorm_silu``).

The port's ``ops.groupnorm_silu`` on CPU tensors runs its plain version
(``ref.py``); it is held against the reference's Pallas kernel (interpret
mode, as ``tests/test_kernels_groupnorm_silu.py`` runs it) and its
``ref.py`` on the same numpy inputs. Bounds: fp32 1e-5 absolute (the
same fp32 two-pass statistics, sums in another order); bf16 one bf16 ulp
of the output plus that 1e-5, since both sides compute in fp32 and round
once, at the store: two fp32 values within 1e-5 round to bf16 values at
most an ulp further apart (near zero an ulp is smaller than the fp32
difference).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.groupnorm_silu import ops as jops
from repro.kernels.groupnorm_silu import ref as jref
from repro.models import temporal_unet as jtu
from repro_torch.kernels.groupnorm_silu import ops, ref
from repro_torch.models import temporal_unet as ttu

torch.set_num_threads(2)

CASES = [
    # B, H, C, groups: the reference kernel test's sweep
    (1, 16, 32, 8),
    (4, 32, 64, 8),
    (16, 8, 128, 8),
    (3, 32, 128, 8),
    (13, 16, 64, 8),
    (2, 16, 4, 8),     # C < groups → g clamps to C
    (8, 30, 96, 6),    # H and C off the TPU tile sizes
]
#: the distinct (H, C) of TRAJ_UNET's 17 launches per forward, g = 8
TRAJ_SHAPES = [(32, 32), (16, 32), (16, 64), (8, 64), (8, 128), (16, 128), (32, 64)]
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, H, C, seed=0, offset=0.0, spread=1.0):
    rng = np.random.default_rng(seed)
    x = offset + spread * rng.standard_normal((B, H, C))
    scale = 1.0 + 0.1 * rng.standard_normal(C)
    bias = 0.1 * rng.standard_normal(C)
    return x.astype(np.float32), scale.astype(np.float32), bias.astype(np.float32)


def _port(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _bf16_ulp(a):
    """Spacing of bf16 values at |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a), ml_dtypes.finfo(ml_dtypes.bfloat16).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_close(got, want, name):
    got, want = _f32(got), _f32(want)
    if name == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        bound = np.maximum(_bf16_ulp(got), _bf16_ulp(want)) + 1e-5
        assert (np.abs(got - want) <= bound).all(), float(np.max(np.abs(got - want) / bound))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("name", sorted(DT))
def test_matches_reference_kernel_and_ref(case, name):
    B, H, C, G = case
    jdt, tdt = DT[name]
    x, s, b = _inputs(B, H, C)
    # affine params in the operand dtype, as a precision policy hands them
    got = ops.groupnorm_silu(_port(x, tdt), _port(s, tdt), _port(b, tdt), groups=G)
    assert got.dtype == tdt and got.shape == (B, H, C)
    jx, js, jb = _jax(x, jdt), _jax(s, jdt), _jax(b, jdt)
    kernel = jops.groupnorm_silu(jx, js, jb, groups=G, interpret=True)
    oracle = jref.groupnorm_silu(jx, js, jb, groups=G)
    assert_close(got, kernel, name)
    assert_close(got, oracle, name)


@pytest.mark.parametrize("hc", TRAJ_SHAPES, ids=str)
@pytest.mark.parametrize("name", sorted(DT))
def test_traj_unet_shapes_match_reference_ref(hc, name):
    H, C = hc
    jdt, tdt = DT[name]
    x, s, b = _inputs(4, H, C, seed=H + C)
    got = ops.groupnorm_silu(_port(x, tdt), torch.from_numpy(s), torch.from_numpy(b),
                             groups=8)
    want = jref.groupnorm_silu(_jax(x, jdt), jnp.asarray(s), jnp.asarray(b), groups=8)
    assert_close(got, want, name)


def test_matches_unfused_chain():
    """The fused path against the temporal UNet's unfused chain
    ``silu(_groupnorm(...))``: fp32 1e-6 (the same arithmetic); bf16
    4e-2, since the chain rounds twice (the norm's store, then SiLU's)
    and the fused path once, as the reference kernel test holds it."""
    x, s, b = _inputs(4, 16, 64, seed=1)
    for name, tol in (("fp32", 1e-6), ("bf16", 4e-2)):
        jdt, tdt = DT[name]
        xs, ss, bs = (_port(a, tdt) for a in (x, s, b))
        fused = ops.groupnorm_silu(xs, ss, bs, groups=8)
        chain = torch.nn.functional.silu(ttu._groupnorm(xs, ss, bs, 8))
        np.testing.assert_allclose(_f32(fused), _f32(chain), rtol=tol, atol=tol)
        jchain = jax.nn.silu(jtu._groupnorm(*(_jax(a, jdt) for a in (x, s, b)), 8))
        np.testing.assert_allclose(_f32(chain), _f32(jchain), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(DT))
def test_large_offset_stats(name):
    """x = 100 + 2·noise: bf16 statistics, or the one-pass E[x²] − μ²
    form, would lose the variance. The fp32 two-pass statistics keep it:
    the output matches the reference's oracle (within 5e-2, as the
    reference test holds its kernel) and keeps its spread."""
    jdt, tdt = DT[name]
    x, _, _ = _inputs(4, 16, 32, seed=2, offset=100.0, spread=2.0)
    ones, zeros = np.ones(32, np.float32), np.zeros(32, np.float32)
    got = _f32(ops.groupnorm_silu(_port(x, tdt), _port(ones, tdt), _port(zeros, tdt),
                                  groups=8))
    want = _f32(jref.groupnorm_silu(_jax(x, jdt), _jax(ones, jdt), _jax(zeros, jdt),
                                    groups=8))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    assert 0.3 < float(np.std(got)) < 1.2


def test_kernel_sized_offset_case():
    """The card's large-offset case, x = 1e3 + N(0, 1), on the plain
    version: fp32 two-pass statistics recover unit spread. Bound 2e-3:
    the slab sum reaches 1e3·n, where fp32 spacing is about 1e-4·n, and
    the two sides add in another order, so the means differ by a few
    1e-4 of the unit spread."""
    x, _, _ = _inputs(2, 32, 64, seed=3, offset=1e3)
    out = ref.groupnorm_silu(torch.from_numpy(x), torch.ones(64), torch.zeros(64), groups=8)
    want = jref.groupnorm_silu(jnp.asarray(x), jnp.ones(64), jnp.zeros(64), groups=8)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=0, atol=2e-3)
    assert 0.3 < float(out.std()) < 1.2


def test_indivisible_channels_and_bad_operands_raise():
    x = torch.zeros(2, 8, 30)
    with pytest.raises(ValueError, match="divisible"):
        ops.groupnorm_silu(x, torch.ones(30), torch.zeros(30), groups=8)
    with pytest.raises(ValueError, match="scale"):
        ops.groupnorm_silu(x, torch.ones(29), torch.zeros(30), groups=6)
    with pytest.raises(TypeError):
        ops.groupnorm_silu(x.to(torch.float16), torch.ones(30), torch.zeros(30), groups=6)
    with pytest.raises(ValueError, match="B, H, C"):
        ops.groupnorm_silu(torch.zeros(8, 30), torch.ones(30), torch.zeros(30), groups=6)



@pytest.mark.parametrize("hc", TRAJ_SHAPES, ids=str)
@pytest.mark.parametrize("name", sorted(DT))
def test_kernel_config_takes_the_register_path_at_traj_unet_shapes(hc, name):
    """Every (H, C) of a planning forward (128 rows, 8 groups) fits a
    team of lanes: the team is a power of two up to a warp, its vectors
    cover the slab, a block holds whole teams, the grid covers every
    slab, and fp32 loads 16 bytes, bf16 8."""
    H, C = hc
    tdt = DT[name][1]
    cfg = ops.kernel_config(128, H, C, 8, tdt, True)
    n, slabs = H * C // 8, 128 * 8
    assert cfg["path"] == "register"
    team, vecs, threads = cfg["team"], cfg["vecs"], cfg["threads"]
    assert team in (1, 2, 4, 8, 16, 32) and vecs in (1, 2, 4, 8)
    assert team * vecs * 4 >= n and (vecs == 1 or team * (vecs // 2) * 4 < n)
    assert threads % 32 == 0 and threads % team == 0 and threads <= ops.REG_THREADS
    assert cfg["grid"] * (threads // team) >= slabs > (cfg["grid"] - 1) * (threads // team)
    assert cfg["load_bytes"] == 4 * tdt.itemsize
    # a slab of 64 elements takes a half warp, not a whole one
    if n == 64:
        assert team == 16


@pytest.mark.parametrize("shape,why", [
    ((2, 16, 16, 8), "C/g = 2"), ((2, 16, 24, 8), "C/g = 3"), ((2, 16, 4, 8), "C/g = 1"),
    ((1, 64, 256, 8), "slab 2048"), ((1, 48, 96, 4), "slab 1152"),
    ((3, 30, 96, 6), "g = 6"), ((3, 16, 96, 8), "C/(4g) = 3"),
    ((128, 32, 64, 8), "unaligned")], ids=lambda v: str(v))
def test_kernel_config_takes_the_general_path(shape, why):
    B, H, C, G = shape
    cfg = ops.kernel_config(B, H, C, G, torch.float32, why != "unaligned")
    assert cfg["path"] == "general"
    assert cfg["threads"] == ops.THREADS and cfg["grid"] == B * min(G, C)
    assert cfg["load_bytes"] == 4


def test_kernel_config_register_path_limits():
    """The largest register slab (1024: 32 lanes of 8 vectors), a slab of
    one vector, an odd row count (H = 30 leaves lanes idle), and a group
    count the wrapper clamps to C."""
    big = ops.kernel_config(3, 64, 128, 8, torch.float32, True)
    assert big["path"] == "register" and (big["team"], big["vecs"]) == (32, 8)
    assert ops.kernel_config(3, 65, 128, 8, torch.float32, True)["path"] == "general"
    tiny = ops.kernel_config(1, 1, 4, 1, torch.float32, True)
    assert (tiny["team"], tiny["vecs"], tiny["threads"], tiny["grid"]) == (1, 1, 32, 1)
    odd = ops.kernel_config(3, 30, 128, 8, torch.bfloat16, True)
    assert (odd["path"], odd["team"], odd["vecs"], odd["grid"]) == ("register", 32, 4, 6)
    clamp = ops.kernel_config(2, 16, 4, 8, torch.float32, True)  # g = 4, C/g = 1
    assert clamp["path"] == "general" and clamp["grid"] == 8
