"""Port ↔ reference parity: flash attention and the attention owner.

The port's ``ops.attention`` on CPU tensors runs its plain version
(``repro_torch/kernels/flash_attention/ref.py``); it is held against the
reference's Pallas kernel (interpret mode) and its ``ref.py`` on the same
numpy inputs. Bounds: fp32 3e-5, as ``tests/test_kernels_flash_attention.py``
holds the reference kernel to its oracle (online vs two-pass softmax,
sums in another order); bf16 2e-2, one bf16 rounding of the output.

The card's kernel computes both fp32 products in the 3xTF32 split form
on the tensor cores; ``test_3xtf32_split_keeps_fp32_accuracy`` emulates
that scheme here and shows why the split is needed: a single TF32 pass
misses the fp32 bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

CASES = [
    # B, Hq, Hkv, S, D, causal, window, dtype
    (2, 4, 4, 25, 32, False, None, "fp32"),
    (2, 4, 4, 64, 64, False, None, "fp32"),
    (2, 4, 4, 64, 32, True, None, "fp32"),
    (1, 4, 2, 96, 32, True, 16, "fp32"),
    (2, 4, 2, 64, 32, False, None, "fp32"),
    (1, 2, 2, 64, 64, False, None, "bf16"),
]
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": dict(rtol=3e-5, atol=3e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_attention_matches_reference(case):
    B, Hq, Hkv, S, D, causal, window, dt = case
    jdt, tdt = DT[dt]
    arrays = _qkv(B, Hq, Hkv, S, D)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, Hq, S, D)
    kernel = jops.attention(jq, jk, jv, causal=causal, window=window,
                            block_q=32, block_k=32)
    oracle = jref.attention(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL[dt])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dt])


def test_strided_views_match_contiguous():
    """The wrapper takes (b, h, s) strides: a transposed view of a
    (B, S, H, D) tensor gives the contiguous result."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 4, 40, 16, seed=3))
    views = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(ops.attention(*views, causal=False),
                               ops.attention(q, k, v, causal=False),
                               rtol=0, atol=0)


def _model_layout(S=37, Sk=None, seed=1):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    return mk(S), mk(Sk or S), mk(Sk or S)


def test_owner_flash_path_matches_reference_owner():
    arrays = _model_layout()
    got = tattn.attention(*map(torch.from_numpy, arrays), causal=False,
                          use_flash=True)
    want = jattn.attention(*map(jnp.asarray, arrays), causal=False,
                           use_flash=True)
    np.testing.assert_allclose(got.numpy(), _f32(want), **TOL["fp32"])
    assert got.shape == (2, 37, 4, 16)


@pytest.mark.parametrize("kind", ["softcap", "cross_length", "off"])
def test_owner_fallbacks(kind):
    """softcap > 0 and cross-length q/k take the plain path even with
    use_flash, bitwise; use_flash=False is the plain path."""
    arrays = _model_layout(S=8, Sk=16 if kind == "cross_length" else None)
    softcap = 30.0 if kind == "softcap" else 0.0
    use_flash = kind != "off"
    tq, tk, tv = map(torch.from_numpy, arrays)
    got = tattn.attention(tq, tk, tv, causal=False, softcap=softcap,
                          use_flash=use_flash)
    plain = tattn._ref_attention(tq, tk, tv, causal=False, window=None,
                                 softcap=softcap)
    assert torch.equal(got, plain)
    want = jattn._ref_attention(*map(jnp.asarray, arrays), causal=False,
                                window=None, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), _f32(want), **TOL["fp32"])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 3, 8, 16))
    with pytest.raises(ValueError):  # Hq not a multiple of Hkv
        ops.attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 300))
    with pytest.raises(ValueError):  # head dim above 256
        ops.attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 16))
    with pytest.raises(TypeError):
        ops.attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        ops.attention(q, k, v, window=0)


def test_alignment_check_enforces_16_byte_rows():
    """The kernel copies K/V 16 bytes at a time: base pointers and the
    (b, h, s) strides of q, k, v must be whole 16-byte units. The check is
    plain Python, so it runs here on CPU tensors."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 4, 24, 32))
    ops.check_alignment(q, k, v)
    views = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in (q, k, v)]
    ops.check_alignment(*views)  # the model's (B, S, H, D) layout
    ops.check_alignment(q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16))
    ops.check_alignment(q[:1, :1], k[:1, :1], v[:1, :1])  # size-1 dims are never stepped
    wide = torch.zeros(2, 4, 24, 33)
    with pytest.raises(ValueError, match="16-byte"):  # row stride 33 floats
        ops.check_alignment(wide[..., :32], k, v)
    with pytest.raises(ValueError, match="16-byte"):  # base 4 bytes past 16
        ops.check_alignment(q, wide[..., 1:33], v)
    odd = torch.zeros(2, 4, 24, 36, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):  # 36 bf16 = 72 bytes a row
        ops.check_alignment(q.to(torch.bfloat16), k.to(torch.bfloat16), odd[..., :32])


def _tf32(x):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bit masking: what cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_product(a, b, passes):
    """a @ b on TF32 operands with an fp32 sum: one pass (hi·hi) or the
    3xTF32 split (hi·lo + lo·hi first, then hi·hi)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return (ah @ bl + al @ bh) + ah @ bh


def _emulated_attention(q, k, v, passes):
    scale = q.shape[-1] ** -0.5
    s = _tf32_product(q, k.transpose(-1, -2), passes) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _tf32_product(p, v, passes) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("shape", [(8, 12, 256, 64), (1, 4, 64, 256)],
                         ids=["dit", "head_dim_256"])
def test_3xtf32_split_keeps_fp32_accuracy(shape):
    """Attention with both products on emulated TF32 tensor cores, against
    an fp64 oracle, at the DiT's shape and at D = 256: the 3xTF32 split
    stays within the port's fp32 bound 3e-5·(1 + max|out|), one TF32 pass
    misses it. Why the card's fp32 kernel splits every operand."""
    B, H, S, D = shape
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, H, H, S, D, seed=5))
    q64, k64, v64 = (a.double() for a in (q, k, v))
    p64 = torch.softmax(q64 @ k64.transpose(-1, -2) * D ** -0.5, dim=-1)
    oracle = p64 @ v64
    bound = 3e-5 * (1 + float(oracle.abs().max()))
    err = {n: float((_emulated_attention(q, k, v, n).double() - oracle).abs().max())
           for n in (1, 3)}
    assert err[3] <= bound, err
    assert err[1] > bound, err


@pytest.mark.parametrize("B,Hq", [(8, 12), (5461, 12), (17_500, 4), (70_000, 1), (65_535, 1),
                                  (9, 8192)])
def test_batch_ranges_cover_every_head_once(B, Hq):
    """(b, h) pairs sit on ``gridDim.y``, so one launch takes at most
    65,535: the wrapper launches a larger batch in ranges of whole batches
    that cover every (b, h) exactly once; up to 65,535 pairs it is today's
    single launch of all B."""
    ranges = ops.batch_ranges(B, Hq)
    pairs = [(b, h) for b0, nb in ranges for b in range(b0, b0 + nb) for h in range(Hq)]
    assert pairs == [(b, h) for b in range(B) for h in range(Hq)]
    assert all(0 < nb * Hq <= ops.MAX_GRID_HEADS for _, nb in ranges)
    if B * Hq <= ops.MAX_GRID_HEADS:
        assert ranges == [(0, B)]
    else:
        assert len(ranges) > 1
    with pytest.raises(ValueError):
        ops.batch_ranges(1, ops.MAX_GRID_HEADS + 1)
