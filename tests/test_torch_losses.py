"""Port ↔ reference parity: the SDEs' training methods and the DSM loss
(``repro_torch.core.sde``, ``repro_torch.core.losses``).

``perturb``, ``kernel_score`` and ``loss_weight`` on VE, VP and sub-VP
within 1e-6 relative. ``dsm_loss``'s value and the gradient of every
parameter (``jax.value_and_grad`` against ``torch.autograd.grad``) for
the MLP score net, a reduced DiT (2 layers, d_model 64, plain attention)
and a reduced image UNet (base 8, mults (1, 2)), with the reference's
(t, z) replayed from its key (``jax.random.split``, t first), each within
1e-5 relative or 1e-6 absolute. Both bounds are relative to the size of
the terms that make the value: for the SDE methods the magnitudes of the
two terms of a difference (XLA fuses x_t − m·x0 into one rounding, torch
rounds twice), for a gradient the leaf's largest element (at least 1),
since an element near zero is a sum of terms as large as the leaf's.
The zero-initialised output leaves get a seeded perturbation first, so
that no gradient is trivially zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.core import sde as jsde
from repro.models import dit as jdit
from repro.models import score_unet as jsu
from repro_torch.core import losses as tlosses
from repro_torch.core import sde as tsde
from repro_torch.models import dit as tdit
from repro_torch.models import score_unet as tsu

from test_torch_dit import JCFG, TCFG, reference_params

torch.set_num_threads(2)

SDES = {"ve": (jsde.VESDE(), tsde.VESDE()), "vp": (jsde.VPSDE(), tsde.VPSDE()),
        "subvp": (jsde.SubVPSDE(), tsde.SubVPSDE())}


def assert_close_to_terms(got, want, terms, rel, err_msg=""):
    """|got − want| ≤ rel · terms, elementwise (``terms``: the summed
    magnitudes that make each value)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    excess = np.abs(got - want) - rel * np.asarray(terms, np.float64)
    assert excess.max() <= 0, (err_msg, float(np.abs(got - want).max()))

MLP_J = jsu.MLPScoreConfig(dim=2, hidden=32, depth=3, t_dim=16)
MLP_T = tsu.MLPScoreConfig(dim=2, hidden=32, depth=3, t_dim=16)
UNET_J = jsu.UNetConfig(image_size=8, channels=3, base=8, mults=(1, 2), t_dim=32)
UNET_T = tsu.UNetConfig(image_size=8, channels=3, base=8, mults=(1, 2), t_dim=32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bump(a, rng, scale=0.05):
    return (scale * rng.standard_normal(np.shape(a))).astype(np.float32)


def mlp_tree(seed=0):
    """The reference's MLP with its zero last layer perturbed."""
    tree = _np_tree(jsu.init_mlp_score(MLP_J, jax.random.PRNGKey(seed)))
    tree["layers"][-1]["w"] = bump(tree["layers"][-1]["w"], np.random.default_rng(seed))
    return tree


def unet_tree(seed=0):
    """The reference's UNet with conv2 of every block and conv_out perturbed."""
    tree = _np_tree(jsu.init_unet(UNET_J, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    blocks = [d["res"] for d in tree["downs"]] + [tree["mid1"], tree["mid2"]] + [
        u["res"] for u in tree["ups"]]
    for b in blocks:
        b["conv2"] = bump(b["conv2"], rng)
    tree["conv_out"] = bump(tree["conv_out"], rng)
    return tree


def reference_draws(sde, x0, key):
    """The reference dsm_loss's (t, z) for this key."""
    kt, kz = jax.random.split(key)
    t = jax.random.uniform(kt, (x0.shape[0],), minval=sde.t_eps, maxval=sde.T)
    z = jax.random.normal(kz, x0.shape, x0.dtype)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))


@pytest.mark.parametrize("name", sorted(SDES))
def test_training_methods_match(name):
    js, ts = SDES[name]
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((6, 3, 4)).astype(np.float32)
    z = rng.standard_normal((6, 3, 4)).astype(np.float32)
    t = np.linspace(0.01, 1.0, 6).astype(np.float32)
    m, s = (a.numpy()[:, None, None] for a in ts.marginal(torch.from_numpy(t)))
    want_xt = np.asarray(js.perturb(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(z)))
    got_xt = ts.perturb(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(z))
    assert_close_to_terms(got_xt.numpy(), want_xt, np.abs(m * x0) + np.abs(s * z), 1e-6)
    want = js.kernel_score(jnp.asarray(want_xt), jnp.asarray(x0), jnp.asarray(t))
    got = ts.kernel_score(torch.from_numpy(want_xt.copy()), torch.from_numpy(x0),
                          torch.from_numpy(t))
    assert_close_to_terms(got.numpy(), want, (np.abs(want_xt) + np.abs(m * x0)) / s ** 2,
                          1e-6)
    np.testing.assert_allclose(ts.loss_weight(torch.from_numpy(t)).numpy(),
                               np.asarray(js.loss_weight(jnp.asarray(t))), rtol=1e-6)
    # the DSM target is −z/std: kernel_score of the perturbed point
    assert_close_to_terms(got.numpy(), -z / s, (np.abs(want_xt) + np.abs(m * x0)) / s ** 2,
                          1e-5)


def _port_grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return dict(zip(names, grads))


def _check(loss_t, grads_t, loss_j, grads_j, leaf_of):
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    assert (sum(g.numel() for g in grads_t.values())
            == sum(a.size for a in jax.tree_util.tree_leaves(grads_j)))
    for name, g in grads_t.items():
        want = np.asarray(leaf_of(grads_j, name))
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(want).max() > 0, name  # every leaf really gets a gradient
        assert_close_to_terms(g.numpy(), want, np.abs(want) * 10 + scale, 1e-6, name)


def _loss_pair(js, ts, jforward, tmodel, jparams, x0, key, ndim):
    def japply(p, x, t):
        _, std = js.marginal(t)
        return jforward(p, x, t) / std.reshape((-1,) + (1,) * (ndim - 1))

    def tapply(m, x, t):
        _, std = ts.marginal(t)
        return m(x, t) / std.reshape((-1,) + (1,) * (ndim - 1))

    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jlosses.dsm_loss(js, japply, p, jnp.asarray(x0), key)))(jparams)
    t, z = reference_draws(js, jnp.asarray(x0), key)
    loss_t = tlosses.dsm_loss(ts, tapply, tmodel, torch.from_numpy(x0), t=t, z=z)
    return loss_t, _port_grads(tmodel, loss_t), loss_j, grads_j


@pytest.mark.parametrize("name", ["vp", "ve"])
def test_dsm_loss_and_grads_mlp(name):
    js, ts = SDES[name]
    tree = mlp_tree()
    x0 = np.random.default_rng(2).standard_normal((16, 2)).astype(np.float32)
    out = _loss_pair(js, ts, lambda p, x, t: jsu.mlp_score_forward(p, x, t, MLP_J),
                     tsu.mlp_params_from_jax(tree, MLP_T),
                     jax.tree_util.tree_map(jnp.asarray, tree), x0,
                     jax.random.PRNGKey(3), 2)
    # port names "w.0", "b.2" ↔ tree["layers"][i]["w" | "b"]
    _check(*out, lambda g, n: g["layers"][int(n.split(".")[1])][n.split(".")[0]])


DIT_LAYER = {"wq": ("attn", "wq"), "wk": ("attn", "wk"), "wv": ("attn", "wv"),
             "wo": ("attn", "wo"), "w_in": ("mlp", "w_in"), "w_gate": ("mlp", "w_gate"),
             "w_out": ("mlp", "w_out"), "ada": ("ada",), "ada_b": ("ada_b",)}


def _dit_leaf(g, name):
    parts = name.split(".")
    if parts[0] != "blocks":
        return g[name]
    node = g["layers"]
    for key in DIT_LAYER[parts[2]]:
        node = node[key]
    return node[int(parts[1])]


def test_dsm_loss_and_grads_dit():
    js, ts = SDES["vp"]
    tree = reference_params()
    x0 = np.random.default_rng(4).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    out = _loss_pair(js, ts, lambda p, x, t: jdit.dit_forward(p, x, t, JCFG),
                     tdit.params_from_jax(tree, TCFG),
                     jax.tree_util.tree_map(jnp.asarray, tree), x0,
                     jax.random.PRNGKey(5), 4)
    _check(*out, _dit_leaf)


def _unet_leaf(g, name):
    parts = name.split(".")
    if parts[0] in ("down_res", "up_res"):
        top = "downs" if parts[0] == "down_res" else "ups"
        return g[top][int(parts[1])]["res"][parts[2]]
    if parts[0] in ("down", "up"):
        return g[parts[0] + "s"][int(parts[1])][parts[0]]
    if parts[0] in ("mid1", "mid2"):
        return g[parts[0]][parts[1]]
    return g[name]


def test_dsm_loss_and_grads_unet():
    js, ts = SDES["vp"]
    tree = unet_tree()
    x0 = np.random.default_rng(6).uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    out = _loss_pair(js, ts, lambda p, x, t: jsu.unet_forward(p, x, t, UNET_J),
                     tsu.unet_params_from_jax(tree, UNET_T),
                     jax.tree_util.tree_map(jnp.asarray, tree), x0,
                     jax.random.PRNGKey(7), 4)
    _check(*out, _unet_leaf)


def test_dsm_loss_draws_from_the_generator():
    """Without t and z the port draws both from the generator (t first):
    the same seed gives the same loss, t stays in [t_eps, T], and a
    generator is required."""
    ts = tsde.VPSDE()
    model = tsu.mlp_params_from_jax(mlp_tree(), MLP_T)
    apply = lambda m, x, t: m(x, t)
    x0 = torch.randn(32, 2, generator=torch.Generator().manual_seed(0))
    a, b = (tlosses.dsm_loss(ts, apply, model, x0, torch.Generator().manual_seed(9))
            for _ in range(2))
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(9)
    u = torch.rand(32, generator=g)
    z = torch.randn(32, 2, generator=g)
    t = ts.t_eps + u * (ts.T - ts.t_eps)
    assert float(t.min()) >= ts.t_eps and float(t.max()) <= ts.T
    assert torch.equal(a, tlosses.make_loss_fn(ts, apply)(model, x0, t=t, z=z))
    with pytest.raises(ValueError, match="generator"):
        tlosses.dsm_loss(ts, apply, model, x0)
