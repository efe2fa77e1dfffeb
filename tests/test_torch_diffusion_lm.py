"""Port ↔ reference parity: the diffusion LM (``models/diffusion_lm.py``),
a zoo backbone as a score network over token embeddings sampled by the
paper's solver, and mirrors of ``tests/test_diffusion_lm.py``.

The backbone is qwen1.5-0.5b's ``scaled_down()`` with vocabulary 64 (the
reference test's), embed_dim 32. The reference's ``init_diffusion_lm``
draws the weights and ``params_from_jax`` carries them across; its
``out_proj`` is zero at init, so the parity tests fill it (and the qkv
biases, which the forward skips, as the reference's does) with a numpy
draw. Inputs are numpy draws.

Bounds: the forward and the loss rtol = atol = 2e-4, the LM bound (fp32,
sums in another order); ``round_to_tokens`` exactly. ``generate``
replays the reference's prior and noise (its key threading in
``sample``: split into prior and solver keys, then one split a
iteration) through the port's ``prior`` and ``noise_fn`` seams, and
must take the same decisions: per-sample ``nfe``, ``accepted`` and
``rejected`` exactly, ``iterations`` equal, the same tokens, and x
within rtol 1e-4 (plus 1e-5 of max|x|), the bound of
``tests/test_torch_adaptive.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import sde as jsde
from repro.models import diffusion_lm as jdlm
from repro_torch import configs
from repro_torch.core import sde as tsde
from repro_torch.models import diffusion_lm as dlm
from repro_torch.optim import AdamW

from test_torch_adaptive import ReferenceNoise

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(vocab=64):
    jbb = jconfigs.get_config("qwen1.5-0.5b").scaled_down().replace(vocab_size=vocab)
    bb = configs.get_config("qwen1.5-0.5b").scaled_down().replace(vocab_size=vocab)
    return jdlm.DiffusionLMConfig(backbone=jbb, embed_dim=32), dlm.DiffusionLMConfig(
        backbone=bb, embed_dim=32)


@pytest.fixture(scope="module")
def setup():
    """The reference's tree, livened (out_proj and the skipped biases drawn)."""
    jcfg, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jdlm.init_diffusion_lm(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tree["out_proj"] = (0.05 * rng.standard_normal(tree["out_proj"].shape)).astype(np.float32)
    for b in ("bq", "bk", "bv"):
        tree["layers"]["attn"][b] = rng.standard_normal(
            tree["layers"]["attn"][b].shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = dlm.params_from_jax(tree, cfg)
    return jcfg, cfg, jparams, params


def test_forward_matches_reference(setup):
    jcfg, cfg, jparams, params = setup
    x = np.random.default_rng(1).standard_normal((3, 12, 32)).astype(np.float32)
    t = np.linspace(0.05, 0.95, 3).astype(np.float32)
    want = jax.jit(jdlm.diffusion_lm_forward, static_argnums=3)(
        jparams, jnp.asarray(x), jnp.asarray(t), jcfg)
    got = dlm.diffusion_lm_forward(params, torch.from_numpy(x), torch.from_numpy(t), cfg)
    assert float(np.abs(np.asarray(want)).max()) > 0.1  # livened: not the zero net
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_ignores_qkv_biases_and_uses_no_kernel(setup, monkeypatch):
    """The reference's forward skips the backbone's qkv biases and runs
    the plain attention: so does the port's (a reference quirk)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    _, cfg, _, params = setup
    monkeypatch.setattr(flash_ops, "attention", lambda *a, **k: pytest.fail("flash called"))
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([0.3, 0.7])
    a = dlm.diffusion_lm_forward(params, x, t, cfg)
    zeroed = {**params, "layers": {**params["layers"], "attn": {
        k: (torch.zeros_like(v) if k in ("bq", "bk", "bv") else v)
        for k, v in params["layers"]["attn"].items()}}}
    assert torch.equal(a, dlm.diffusion_lm_forward(zeroed, x, t, cfg))


def test_round_to_tokens_matches_reference(setup):
    jcfg, cfg, jparams, params = setup
    x = np.random.default_rng(2).standard_normal((4, 16, 32)).astype(np.float32)
    want = jdlm.round_to_tokens(jparams, jnp.asarray(x))
    got = dlm.round_to_tokens(params, torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_loss_matches_reference_on_its_draws(setup):
    """The reference's (t, z) draws handed to the port's seams."""
    jcfg, cfg, jparams, params = setup
    toks = np.random.default_rng(3).integers(0, 64, (4, 10)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    kt, kz = jax.random.split(key)
    t = jax.random.uniform(kt, (4,), minval=1e-3, maxval=1.0)
    z = jax.random.normal(kz, (4, 10, 32), jnp.float32)
    js = jsde.VPSDE()
    assert (js.t_eps, js.T) == (1e-3, 1.0)
    want = jdlm.diffusion_lm_loss(jparams, jcfg, js, jnp.asarray(toks), key)
    got = dlm.diffusion_lm_loss(params, cfg, tsde.VPSDE(), torch.from_numpy(toks),
                                t=torch.from_numpy(np.array(t)), z=torch.from_numpy(np.array(z)))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_params_tree_matches_reference_layout():
    jcfg, cfg = _cfgs()
    jtree = jdlm.init_diffusion_lm(jcfg, jax.random.PRNGKey(0))
    ours = dlm.init_diffusion_lm(cfg, 0, device="cpu")
    from repro_torch.models.transformer import _map
    assert _map(lambda a: tuple(a.shape), ours) == jax.tree.map(lambda a: a.shape, jtree)
    assert float(ours["out_proj"].abs().max()) == 0.0  # zero at init, as the reference's
    norms = torch.linalg.norm(ours["token_embed"], dim=1)
    np.testing.assert_allclose(norms.numpy(), 1.0, rtol=1e-6)
    dlm.liven(ours, torch.Generator().manual_seed(1))
    assert float(ours["out_proj"].abs().max()) > 0.0


def test_generate_adaptive_matches_reference_on_replayed_noise(setup):
    """``generate(method="adaptive")`` from the reference's prior with its
    noise replayed: the same decisions and tokens, through the plain and
    the fused step."""
    jcfg, cfg, jparams, params = setup
    js, ts = jsde.VPSDE(), tsde.VPSDE()
    key = jax.random.PRNGKey(5)
    jtoks, jres = jax.jit(lambda k: jdlm.generate(jparams, jcfg, js, 4, 8, k,
                                                  method="adaptive", eps_rel=0.1))(key)
    k_prior, k_solve = jax.random.split(key)
    prior = torch.from_numpy(np.array(js.prior_sample(k_prior, (4, 8, 32))))
    for fused in (False, True):
        toks, res = dlm.generate(params, cfg, ts, 4, 8, method="adaptive", device="cpu",
                                 prior=prior, noise_fn=ReferenceNoise(k_solve), eps_rel=0.1,
                                 use_fused_kernel=fused)
        for name in ("nfe", "accepted", "rejected"):
            np.testing.assert_array_equal(getattr(res, name).numpy(),
                                          np.asarray(getattr(jres, name)), err_msg=name)
        assert int(res.iterations) == int(jres.iterations)
        want_x = np.asarray(jres.x)
        np.testing.assert_allclose(res.x.numpy(), want_x, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(want_x).max())))
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert int(res.rejected.sum()) > 0 or int(res.iterations) > 10


def test_generate_rejects_a_prior_of_another_shape(setup):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match="prior"):
        dlm.generate(params, cfg, tsde.VPSDE(), 4, 8, device="cpu",
                     prior=torch.zeros(4, 9, 32), noise_fn=lambda x: torch.zeros_like(x))


def test_config_refuses_ssm_backbones():
    with pytest.raises(ValueError, match="self-attention"):
        dlm.DiffusionLMConfig(backbone=configs.get_config("mamba2-2.7b").scaled_down())


# --- mirrors of tests/test_diffusion_lm.py, on the port alone -----------------

@pytest.fixture(scope="module")
def port_only():
    _, cfg = _cfgs()
    return cfg, tsde.VPSDE(), dlm.init_diffusion_lm(cfg, 0, device="cpu")


def test_forward_shape_and_finite(port_only):
    cfg, sde, params = port_only
    x = torch.randn(2, 12, cfg.embed_dim, generator=torch.Generator().manual_seed(0))
    out = dlm.diffusion_lm_forward(params, x, torch.linspace(0.1, 0.9, 2), cfg)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_rounding_inverts_embedding(port_only):
    cfg, sde, params = port_only
    toks = torch.randint(0, cfg.backbone.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(dlm.round_to_tokens(params, dlm.embed(params, toks)), toks.int())


def test_generation_runs_with_adaptive_solver(port_only):
    cfg, sde, params = port_only
    toks, res = dlm.generate(params, cfg, sde, batch=4, seq=8, seed=0, method="adaptive",
                             device="cpu", eps_rel=0.1)
    assert toks.shape == (4, 8)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.backbone.vocab_size
    assert float(res.mean_nfe) > 0


def test_training_reduces_loss(port_only):
    """Short DSM training on a 2-token repeating language reduces the loss
    (the embedding geometry is frozen; only the net moves)."""
    cfg, sde, _ = port_only
    params = dlm.init_diffusion_lm(cfg, 0, device="cpu")
    trainable = dlm.trainable(params)
    assert "token_embed" not in trainable and "layers/attn/wq" in trainable
    for p in trainable.values():
        p.requires_grad_(True)
    opt = AdamW(lr=2e-3, weight_decay=0.0)
    state = opt.init(trainable)
    g = torch.Generator().manual_seed(0)
    first = None
    for _ in range(60):
        toks = (torch.randint(0, 2, (8, 1), generator=g) * 3).repeat(1, 12)
        loss = dlm.diffusion_lm_loss(params, cfg, sde, toks, g)
        grads = torch.autograd.grad(loss, list(trainable.values()), allow_unused=True)
        # the qkv biases the forward skips get zero gradients, as in JAX
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(trainable.items(), grads)}
        _, state = opt.update(grads, state, trainable)
        first = float(loss.detach()) if first is None else first
    assert float(loss.detach()) < first * 0.9, (first, float(loss.detach()))


def test_demo_on_the_cpu(capsys):
    from repro_torch.examples import diffusion_lm_demo

    rows = diffusion_lm_demo.main(["--device", "cpu", "--steps", "3"])
    assert [r["method"] for r in rows] == ["adaptive", "adaptive", "em"]
    assert rows[2]["nfe"] == 201 and all(r["nfe"] > 0 for r in rows)
    assert "pattern-consistency" in capsys.readouterr().out
