"""Port ↔ reference parity: the MLP score net and the image UNet
(``repro_torch.models.score_unet``).

Forwards through ``*_params_from_jax`` within 1e-5 of the output's
largest magnitude (at least 1; fp32 sums in another order, and an output
near zero is a sum of terms of that size); the SAME convolution against ``lax.conv_general_dilated`` at odd
and even sizes and both strides (XLA pads a stride-2 3×3 kernel (0, 1)
at even sizes); ``make_score_fn`` against the reference's; a fresh net's
zero-initialised leaves are zero and its score exactly 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sde as jsde
from repro.models import score_unet as jsu
from repro_torch.core import sde as tsde
from repro_torch.core.precision import resolve_policy
from repro_torch.models import score_unet as tsu

from test_torch_losses import MLP_J, MLP_T, UNET_J, UNET_T, mlp_tree, unet_tree

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, want):
    want = np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


def test_mlp_forward_and_score_match():
    tree = mlp_tree()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 2)).astype(np.float32)
    t = np.linspace(0.01, 1.0, 9).astype(np.float32)
    model = tsu.mlp_params_from_jax(tree, MLP_T)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jsu.mlp_score_forward(jp, jnp.asarray(x), jnp.asarray(t), MLP_J)
    with torch.no_grad():
        got = tsu.mlp_score_forward(model, _t(x), _t(t))
    assert_close(got, want)
    js, ts = jsde.VPSDE(), tsde.VPSDE()
    want = jsu.make_score_fn(jsu.mlp_score_forward, jp, MLP_J, js)(jnp.asarray(x),
                                                                    jnp.asarray(t))
    with torch.no_grad():
        got = tsu.make_score_fn(model, ts)(_t(x), _t(t))
    assert_close(got, want)


@pytest.mark.parametrize("size", [8, 16])
def test_unet_forward_and_score_match(size):
    jcfg = dataclasses.replace(UNET_J, image_size=size)
    tcfg = dataclasses.replace(UNET_T, image_size=size)
    tree = unet_tree()
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    t = np.array([0.1, 0.9], np.float32)
    model = tsu.unet_params_from_jax(tree, tcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jax.jit(lambda p, x, t: jsu.unet_forward(p, x, t, jcfg))(jp, jnp.asarray(x),
                                                                    jnp.asarray(t))
    with torch.no_grad():
        got = tsu.unet_forward(model, _t(x), _t(t))
    assert got.shape == x.shape
    assert_close(got, want)
    assert np.abs(got.numpy()).mean() > 1e-2
    js, ts = jsde.VESDE(), tsde.VESDE()
    want = jax.jit(jsu.make_score_fn(jsu.unet_forward, jp, jcfg, js))(jnp.asarray(x),
                                                                      jnp.asarray(t))
    with torch.no_grad():
        got = tsu.make_score_fn(model, ts)(_t(x), _t(t))
    assert_close(got, want)


def test_unet_bf16_policy_runs_in_compute_dtype():
    tree = unet_tree()
    model = tsu.unet_params_from_jax(tree, UNET_T)
    x = torch.zeros(2, 8, 8, 3)
    t = torch.tensor([0.2, 0.7])
    pol = resolve_policy("bf16")
    with torch.no_grad():
        out = tsu.unet_forward(model, x, t, policy=pol)
        score = tsu.make_score_fn(model, tsde.VPSDE(), policy=pol)(x, t)
    assert out.dtype == torch.bfloat16 and score.dtype == torch.float32


@pytest.mark.parametrize("h,w", [(15, 17), (32, 32), (7, 8)])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_same_convolution_matches_xla(h, w, k, stride):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    wt = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(wt), (stride, stride),
                                        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tsu.conv(_t(x).permute(0, 3, 1, 2), _t(wt), stride=stride).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_same_pad_is_xlas_rule():
    assert tsu.same_pad(32, 3, 2) == (0, 1)   # not (1, 1)
    assert tsu.same_pad(15, 3, 2) == (1, 1)
    assert tsu.same_pad(32, 3, 1) == (1, 1)
    assert tsu.same_pad(16, 1, 2) == (0, 0)


def test_fresh_nets_start_at_zero_and_match_the_reference_layout():
    g = torch.Generator().manual_seed(0)
    mlp = tsu.init_mlp_score(MLP_T, g)
    assert not mlp.w[-1].any() and all(not b.any() for b in mlp.b)
    assert all(w.std() > 0 for w in list(mlp.w)[:-1])
    jm = jsu.init_mlp_score(MLP_J, jax.random.PRNGKey(0))
    assert tsu.param_count(mlp) == sum(a.size for a in jax.tree_util.tree_leaves(jm))
    with torch.no_grad():
        assert not mlp(torch.randn(4, 2), torch.rand(4)).any()

    unet = tsu.init_unet(UNET_T, g)
    ju = jsu.init_unet(UNET_J, jax.random.PRNGKey(0))
    assert tsu.param_count(unet) == sum(a.size for a in jax.tree_util.tree_leaves(ju))
    assert not unet.conv_out.any()
    for _, block in tsu._blocks(unet):
        assert not block.conv2.any() and block.conv1.std() > 0
        assert torch.equal(block.gn1_s, torch.ones_like(block.gn1_s))
    with torch.no_grad():
        assert not unet(torch.randn(2, 8, 8, 3), torch.rand(2)).any()
    # the port's draws have the reference's scales: dense fan_in^-1/2, conv (kh·kw·cin)^-1/2
    ref = np.asarray(ju["downs"][1]["down"])
    assert unet.down[1].std().item() == pytest.approx(float(ref.std()), rel=0.15)
    ported = tsu.unet_params_from_jax(jax.tree_util.tree_map(np.asarray, ju), UNET_T)
    for (n, p), (_, q) in zip(unet.named_parameters(), ported.named_parameters()):
        assert p.shape == q.shape, n


def test_params_from_jax_rejects_a_wrong_tree():
    tree = mlp_tree()
    with pytest.raises(ValueError):
        tsu.mlp_params_from_jax(tree, dataclasses.replace(MLP_T, depth=2))
    tree = unet_tree()
    tree["conv_out"] = tree["conv_out"][..., :2]
    with pytest.raises(ValueError):
        tsu.unet_params_from_jax(tree, UNET_T)
