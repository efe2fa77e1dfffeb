"""Training in the port: the MLP score net's loop against the
reference's, the DiT's gradients, and the CUDA wrappers' autograd guard.

* 30 steps of ``benchmarks.common.train_mlp`` at batch 64 from the
  reference's initial parameters, with its data, t and z replayed from
  its key threading (``split(key, 3)`` a step: data, then the loss's key),
  end with the reference's EMA parameters within 1e-4.
* A reference-trained net carried across by ``mlp_params_from_jax`` gives
  the reference's ``score_fn`` within 1e-5.
* The port's own short run lowers the loss.
* After one DiT training step every leaf has a nonzero gradient
  (``pos_emb`` included); a ``sample`` result carries no ``grad_fn``.
* ``kernels.autograd.refuse_autograd`` and each CUDA launch path: under
  grad mode an input that requires grad raises before anything is built;
  the plain versions (CPU tensors) keep flowing gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.core import VPSDE as JVPSDE
from repro.core import dsm_loss as jdsm
from repro.models import score_unet as jsu
from repro.optim import AdamW as JAdamW
from repro.optim import ema_init, ema_params, ema_update
from repro_torch.benchmarks import common
from repro_torch.configs.diffusion import TOY_MLP
from repro_torch.core import analytic
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VPSDE
from repro_torch.kernels import _build
from repro_torch.kernels.autograd import refuse_autograd
from repro_torch.models import dit as tdit
from repro_torch.models import score_unet as tsu

from test_torch_dit import TCFG, reference_params

torch.set_num_threads(2)

J_MLP = jsu.MLPScoreConfig(dim=2, hidden=128, depth=3)


def reference_training(steps: int, batch: int, seed: int = 0):
    """The reference's ``trained_mlp_score`` loop at ``batch``; returns
    (initial tree, final EMA tree, [(x0, t, z)] of every step)."""
    sde = JVPSDE()
    key = jax.random.PRNGKey(seed)
    params = jsu.init_mlp_score(J_MLP, key)
    init = jax.tree_util.tree_map(np.asarray, params)
    opt = JAdamW(lr=2e-3, weight_decay=0.0)
    opt_state, ema = opt.init(params), ema_init(params)

    def apply_fn(p, x, t):
        _, std = sde.marginal(t)
        return jsu.mlp_score_forward(p, x, t, J_MLP) / std[:, None]

    @jax.jit
    def step(params, opt_state, ema, key):
        key, kd, kl = jax.random.split(key, 3)
        x0 = jcommon.GMM.sample(kd, batch)
        kt, kz = jax.random.split(kl)
        t = jax.random.uniform(kt, (batch,), minval=sde.t_eps, maxval=sde.T)
        z = jax.random.normal(kz, x0.shape, x0.dtype)
        grads = jax.grad(lambda p: jdsm(sde, apply_fn, p, x0, kl))(params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, ema_update(ema, params, 0.995), key, (x0, t, z)

    draws = []
    for _ in range(steps):
        params, opt_state, ema, key, d = step(params, opt_state, ema, key)
        draws.append(tuple(torch.from_numpy(np.array(a)) for a in d))
    final = jax.tree_util.tree_map(np.asarray, ema_params(ema, params))
    return init, final, draws, apply_fn


@pytest.fixture(scope="module")
def reference_run():
    return reference_training(30, 64)


def test_replayed_training_matches_reference(reference_run):
    init, final, draws, _ = reference_run
    net = common.train_mlp("vp", 30, device="cpu", batch=64,
                           model=tsu.mlp_params_from_jax(init, TOY_MLP),
                           draws=lambda i: draws[i])
    assert net.losses.shape == (30,) and np.isfinite(net.losses).all()
    assert not any(p.requires_grad for p in net.model.parameters())
    for i, lp in enumerate(final["layers"]):
        np.testing.assert_allclose(net.model.w[i].numpy(), lp["w"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(net.model.b[i].numpy(), lp["b"], rtol=1e-4, atol=1e-4)


def test_carried_net_gives_the_reference_score(reference_run):
    _, final, _, apply_fn = reference_run
    rng = np.random.default_rng(0)
    x = (2.0 * rng.standard_normal((32, 2))).astype(np.float32)
    t = np.linspace(1e-3, 1.0, 32).astype(np.float32)
    want = apply_fn(jax.tree_util.tree_map(jnp.asarray, final), jnp.asarray(x),
                    jnp.asarray(t))
    net = common.TrainedMLP(sde=VPSDE(), model=tsu.mlp_params_from_jax(final, TOY_MLP),
                            losses=np.zeros(0), seconds=0.0)
    with torch.no_grad():
        got = net.score_fn(torch.from_numpy(x), torch.from_numpy(t))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_own_short_run_lowers_the_loss():
    net = common.train_mlp("vp", 150, seed=1, device="cpu", batch=128)
    assert np.isfinite(net.losses).all()
    assert net.losses[-20:].mean() < 0.7 * net.losses[:20].mean()


def test_dit_training_step_reaches_every_leaf():
    """The plain paths (CPU tensors; the flash wrapper's plain version)
    carry gradients to every leaf of a livened DiT."""
    tree = reference_params()
    model = tdit.params_from_jax(tree, dataclasses.replace(TCFG, use_flash=True))
    assert all(p.requires_grad for p in model.parameters())
    sde = VPSDE()
    g = torch.Generator().manual_seed(0)
    x0 = torch.rand(3, 16, 16, 3, generator=g) * 2 - 1
    apply = lambda m, x, t: m(x, t) / sde.marginal(t)[1].reshape(-1, 1, 1, 1)
    from repro_torch.core.losses import dsm_loss

    dsm_loss(sde, apply, model, x0, g).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
    assert model.pos_emb.grad.abs().max() > 0


def test_sample_carries_no_graph():
    model = tdit.params_from_jax(reference_params(), TCFG)
    score = tdit.make_score_fn(model, VPSDE())
    for method, kw in (("adaptive", dict(eps_rel=0.5)), ("em", dict(n_steps=3))):
        res = sample(VPSDE(), score, (2, 16, 16, 3), seed=0, method=method, device="cpu",
                     **kw)
        assert res.x.grad_fn is None and not res.x.requires_grad


def test_refuse_autograd():
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(3)
    refuse_autograd("k", b, None)  # nothing requires grad
    with pytest.raises(ValueError, match="no backward|backward kernel"):
        refuse_autograd("k", b, a)
    with torch.no_grad():
        refuse_autograd("k", a)  # grad mode off: the launch may go ahead


def _never(*args, **kwargs):
    raise AssertionError("the kernel was built for an input that requires grad")


def test_every_launch_path_refuses_autograd(monkeypatch):
    """Each wrapper's launch refuses before building anything (so the
    check runs here, where nothing can be built); its CPU branch keeps
    the plain version's gradients."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.groupnorm_silu import ops as gn_ops
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    monkeypatch.setattr(_build, "library", _never)
    r = lambda *s: torch.randn(*s, requires_grad=True)
    c = torch.rand(2)
    calls = {
        "solver_step": lambda: step_ops._launch(r(2, 8), *(torch.zeros(2, 8) for _ in range(4)),
                                                c, c, c, c, c, use_prev=True),
        "em_step": lambda: step_ops._launch_em(torch.zeros(2, 8), r(2, 8), torch.zeros(2, 8),
                                               c, c, c),
        "flash_attention": lambda: flash_ops._launch(r(1, 2, 8, 16), r(1, 2, 8, 16),
                                                     r(1, 2, 8, 16), causal=False,
                                                     window=None, scale=0.25, true_len=None),
        "groupnorm_silu": lambda: gn_ops._launch(r(2, 8, 16), torch.ones(16),
                                                 torch.zeros(16), groups=4, eps=1e-6),
        "ssd_scan": lambda: ssd_ops._launch(r(1, 8, 2, 16), torch.rand(1, 8, 2),
                                            -torch.rand(2), torch.randn(1, 8, 1, 16),
                                            torch.randn(1, 8, 1, 16), return_state=False),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match=name):
            call()
    # the plain versions carry gradients
    q = r(1, 2, 8, 16)
    flash_ops.attention(q, q.detach(), q.detach(), causal=False).sum().backward()
    x = r(2, 8, 16)
    gn_ops.groupnorm_silu(x, torch.ones(16), torch.zeros(16), groups=4).sum().backward()
    xs = r(2, 8)
    step_ops.em_step(xs, torch.zeros(2, 8), torch.zeros(2, 8), c, c, c).sum().backward()
    assert q.grad.abs().max() > 0 and x.grad.abs().max() > 0 and xs.grad.abs().max() > 0


def test_analytic_sampling_is_unchanged_by_grad_mode():
    """The solvers run under no_grad whatever the caller's mode."""
    sde = VPSDE()
    with torch.enable_grad():
        a = sample(sde, analytic.gaussian_score(sde), (4, 3), seed=0, device="cpu")
    with torch.no_grad():
        b = sample(sde, analytic.gaussian_score(sde), (4, 3), seed=0, device="cpu")
    assert torch.equal(a.x, b.x)


def test_train_diffusion_checkpoint_reloads_the_sampling_net(tmp_path):
    """``train`` returns the EMA net under ``sampling_cfg`` (flash on) and
    ``load_trained`` rebuilds the same net from its checkpoint."""
    from repro_torch.examples import train_diffusion

    run = train_diffusion.train("small", steps=2, batch=2, device="cpu",
                                ckpt_dir=str(tmp_path), log_every=0)
    assert run.losses.shape == (2,) and np.isfinite(run.losses).all()
    assert run.ms_per_step.shape == (2,) and run.peak_bytes is None
    want = train_diffusion.sampling_cfg("small")
    assert want.use_flash and run.model.cfg == want
    model = train_diffusion.load_trained(str(tmp_path), "small", "cpu")
    assert model.cfg == want and not any(p.requires_grad for p in model.parameters())
    for a, b in zip(model.state_dict().values(), run.model.state_dict().values()):
        assert torch.equal(a, b)
