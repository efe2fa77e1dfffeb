"""Port ↔ reference parity: the temporal UNet
(``repro_torch.models.temporal_unet``).

Parameters come from the reference's ``init_temporal_unet``, livened
(``conv2``, ``conv_out`` and the attention ``wo`` start at zero, so a
fresh net returns exactly 0 and a comparison would pass vacuously), and
are carried across by ``params_from_jax``. The reference runs its fused
path as its own tests run it on the CPU (Pallas in interpret mode).
Bounds are the ``TOLS`` of ``tests/test_score_hotpath.py``: fp32 1e-4
(convolutions and sums in another order), bf16 presets 5e-2 (bf16
inputs to the convolutions and products, roundings at other places in
the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.precision import resolve_policy as jpolicy
from repro.core.sde import VPSDE as JVPSDE
from repro.models import temporal_unet as jtu
from repro_torch.configs.diffusion import TRAJ_UNET
from repro_torch.core.precision import resolve_policy
from repro_torch.core.sde import VPSDE
from repro_torch.models import temporal_unet as ttu

torch.set_num_threads(2)

TOLS = {"fp32": dict(rtol=1e-4, atol=1e-4),
        "bf16": dict(rtol=5e-2, atol=5e-2),
        "bf16_full": dict(rtol=5e-2, atol=5e-2)}
SMALL = dict(horizon=8, transition_dim=6, base=8, mults=(1, 2), t_dim=16, groups=4,
             returns_bins=3, attention=True, attn_heads=2)
JCFG = jtu.TemporalUNetConfig(**SMALL)
TCFG = ttu.TemporalUNetConfig(**SMALL)


def liven(tree, seed=7, scale=0.05, wo=True):
    """numpy tree with the zero-init leaves replaced by scale·N(0, 1)."""
    rng = np.random.default_rng(seed)
    bump = lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32)
    blocks = ([d["res"] for d in tree["downs"]] + [tree["mid1"], tree["mid2"]]
              + [u["res"] for u in tree["ups"]])
    for blk in blocks:
        blk["conv2"] = bump(blk["conv2"])
    tree["conv_out"] = bump(tree["conv_out"])
    if wo and "attn" in tree:
        tree["attn"]["wo"] = bump(tree["attn"]["wo"])
    return tree


def reference_params(cfg=JCFG, livened=True, seed=0, **kw):
    tree = jax.tree_util.tree_map(
        np.asarray, jtu.init_temporal_unet(cfg, jax.random.PRNGKey(seed)))
    return liven(tree, **kw) if livened else tree


def _inputs(B=3, cfg=SMALL, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg["horizon"], cfg["transition_dim"])).astype(np.float32)
    return x, np.linspace(0.1, 1.0, B).astype(np.float32)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _fast(cfg, on):
    return dataclasses.replace(cfg, use_flash=on, use_fused_norm=on)


@pytest.mark.parametrize("fast", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("labels", [False, True], ids=["uncond", "labels"])
@pytest.mark.parametrize("preset", sorted(TOLS))
def test_forward_matches_reference(preset, labels, fast):
    tree = reference_params()
    x, t = _inputs()
    jcfg, tcfg = _fast(JCFG, fast), _fast(TCFG, fast)
    jp, tp = jpolicy(preset), resolve_policy(preset)
    y = np.array([0, -1, 2], np.int32) if labels else None
    want = jtu.temporal_unet_forward(
        jp.cast_params(jax.tree_util.tree_map(jnp.asarray, tree)), jnp.asarray(x),
        jnp.asarray(t), jcfg, policy=jp, y=None if y is None else jnp.asarray(y))
    model = ttu.params_from_jax(tree, tcfg).to(tp.param)
    got = ttu.temporal_unet_forward(model, torch.from_numpy(x), torch.from_numpy(t),
                                    policy=tp, y=None if y is None else torch.from_numpy(y))
    assert got.dtype == tp.compute and got.shape == x.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS[preset])
    assert float(np.abs(_f32(want)).mean()) > 1e-2


@pytest.mark.parametrize("preset", ["fp32", "bf16_full"])
def test_score_fn_matches_reference(preset):
    tree = reference_params()
    x, t = _inputs()
    y = np.array([1, 2, -1], np.int32)
    jp, tp = jpolicy(preset), resolve_policy(preset)
    jscore = jtu.make_score_fn(jax.tree_util.tree_map(jnp.asarray, tree), JCFG,
                               JVPSDE(), policy=jp)
    tscore = ttu.make_score_fn(ttu.params_from_jax(tree, TCFG), VPSDE(), policy=tp)
    want = jscore(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    got = tscore(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    assert got.dtype == tp.state
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS[preset])


@pytest.mark.parametrize("cfg", [SMALL, dict(dataclasses.asdict(TRAJ_UNET), attention=True),
                                 dict(SMALL, attention=False, returns_bins=0,
                                      mults=(1, 2, 4), horizon=16)],
                         ids=["small", "traj_unet", "no_attn"])
def test_param_tree_matches_reference(cfg):
    """The port's parameter tree has the reference's keys and shapes,
    the TRAJ_UNET tree included (its attention block appended last)."""
    jtree = jax.eval_shape(lambda k: jtu.init_temporal_unet(
        jtu.TemporalUNetConfig(**cfg), k), jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), jtree)
    assert ttu.param_shapes(ttu.TemporalUNetConfig(**cfg)) == want


def test_params_from_jax_rejects_mismatch():
    tree = reference_params(livened=False)
    tree["mid1"]["conv1"] = tree["mid1"]["conv1"][:-1]
    with pytest.raises(ValueError, match="mid1/conv1"):
        ttu.params_from_jax(tree, TCFG)
    with pytest.raises(ValueError, match="keys"):
        ttu.params_from_jax(reference_params(livened=False),
                            dataclasses.replace(TCFG, attention=False))


def test_bf16_tree_loads_bit_exactly():
    tree = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                  reference_params())
    model = ttu.params_from_jax(tree, TCFG)
    got = model["mid1"]["conv1"].detach().view(torch.int16).numpy()
    np.testing.assert_array_equal(got, tree["mid1"]["conv1"].view(np.int16))
    assert model["t_w1"].dtype == torch.bfloat16


def test_fresh_net_is_zero_liven_is_not_and_keeps_null_row():
    x, t = _inputs()
    x, t = torch.from_numpy(x), torch.from_numpy(t)
    model = ttu.init_temporal_unet(TCFG, torch.Generator().manual_seed(0))
    assert not model(x, t).any()
    assert not model["ret_emb"][TCFG.returns_bins].any()
    assert float(model["ret_emb"][:TCFG.returns_bins].abs().mean()) > 1e-3
    ttu.liven_zero_init(model, torch.Generator().manual_seed(1))
    assert float(model(x, t).abs().mean()) > 1e-2
    assert not model["ret_emb"][TCFG.returns_bins].any()


def test_fresh_attention_block_bitwise_neutral():
    """Zero-init ``wo``: a fresh bottleneck attention block is the
    identity, so attention on and off give bitwise the same output."""
    tree = reference_params(wo=False)
    x, t = _inputs()
    on = ttu.params_from_jax(tree, TCFG)(torch.from_numpy(x), torch.from_numpy(t))
    tree.pop("attn")
    off_cfg = dataclasses.replace(TCFG, attention=False)
    off = ttu.params_from_jax(tree, off_cfg)(torch.from_numpy(x), torch.from_numpy(t))
    assert torch.equal(on, off)


def test_off_state_is_unfused_chain():
    """``fused=False`` is literally ``silu(_groupnorm(...))``, bitwise."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 16, 32)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(32)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(32)).astype(np.float32))
    a = ttu._gn_silu(x, scale, bias, 4, fused=False)
    assert torch.equal(a, F.silu(ttu._groupnorm(x, scale, bias, 4)))
    assert not TCFG.use_fused_norm and not TCFG.use_flash


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_groupnorm_fp32_stats_large_offset(dtype):
    """x = 100 + 2·noise: fp32 statistics keep the variance, so each
    (sample, group) slab comes out zero-mean and unit-std, and matches
    the reference's ``_groupnorm`` on the same quantised input."""
    B, H, C, g = 4, 16, 32, 8
    noise = 2.0 * np.random.default_rng(5).standard_normal((B, H, C))
    x = torch.from_numpy((100.0 + noise).astype(np.float32)).to(dtype)
    out = _f32(ttu._groupnorm(x, torch.ones(C, dtype=dtype), torch.zeros(C, dtype=dtype), g))
    slabs = out.reshape(B, H, g, C // g)
    tol = 5e-3 if dtype == torch.float32 else 6e-2  # bf16 quantises x itself
    np.testing.assert_allclose(slabs.mean(axis=(1, 3)), 0.0, atol=tol)
    np.testing.assert_allclose(slabs.std(axis=(1, 3)), 1.0, atol=2 * tol)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jtu._groupnorm(jnp.asarray(_f32(x)).astype(jdt), jnp.ones(C, jdt),
                          jnp.zeros(C, jdt), g)
    np.testing.assert_allclose(out, _f32(want), **TOLS["fp32" if dtype == torch.float32
                                                        else "bf16"])


@pytest.mark.parametrize("H,k,stride", [(32, 5, 2), (16, 5, 2), (8, 5, 1), (9, 5, 2),
                                        (32, 1, 1), (7, 3, 2), (4, 5, 1)])
def test_conv_same_padding_matches_xla(H, k, stride):
    """``_conv`` pads as XLA's "SAME" does: at stride 2, kernel 5 and an
    even H that is 1 on the left and 2 on the right."""
    rng = np.random.default_rng(H * 10 + k)
    x = rng.standard_normal((2, H, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    want = jtu._conv(jnp.asarray(x), jnp.asarray(w), stride=stride)
    got = ttu._conv(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if stride == 2 and k == 5 and H % 2 == 0:  # a symmetric pad shifts every output
        sym = F.conv1d(torch.from_numpy(x).transpose(1, 2),
                       torch.from_numpy(w).permute(2, 1, 0), stride=2, padding=2)
        assert not np.allclose(sym.transpose(1, 2).numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("H", [4, 8, 16])
def test_upsample_matches_jax_image_resize(H):
    x = np.random.default_rng(H).standard_normal((2, H, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 2 * H, 3), "nearest")
    np.testing.assert_array_equal(ttu._upsample2(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
