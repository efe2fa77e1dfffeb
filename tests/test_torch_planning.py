"""Port ↔ reference parity: single-shot trajectory planning
(``repro_torch.planning``) and the temporal UNet's planning contract.

Mirrors ``tests/test_planning.py`` (the parts on the single-shot path):
the UNet's shapes, checks, precision and null row; the plan-conditioner
factory; returns CFG at scale 0 and an absent state pin bitwise equal to
the unconditional solve; exact pinning of the current state; chunked
equal to monolithic with the payload aboard. Whole ``plan()`` solves are
held to the reference's on its own prior and noise (z, then the
projection draw): per-sample nfe/accepted/rejected and iterations
exactly equal, x within the bounds of ``tests/test_torch_adaptive.py``,
the pinned coordinates exactly ``obs``. The reference runs the solver
step in jnp (``use_fused_kernel=False``): its fused kernel reads past
its padded D when the padded D exceeds 512 and is no multiple of it
(ROADMAP §C); the port's fused step masks its ragged tile and runs both
ways here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as jan
from repro.core import sde as jsde
from repro.core.solvers.adaptive import AdaptiveConfig as JConfig
from repro.kernels.solver_step import ops as jstep
from repro.models import temporal_unet as jtu
from repro.planning import planner as jpl
from repro_torch.core import analytic as tan
from repro_torch.core import sde as tsde
from repro_torch.core.guidance import ClassifierFree, Inpaint
from repro_torch.core.precision import resolve_policy
from repro_torch.core.sampling import sample, solve_in_chunks
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.kernels.solver_step import ops as tstep
from repro_torch.models import temporal_unet as ttu
from repro_torch.planning import (
    PlanConditioner, PlannerConfig, first_action, plan, plan_conditioner,
    returns_to_bin, state_pin,
)

from test_torch_adaptive import ReferenceNoise, _assert_same_solve
from test_torch_temporal_unet import reference_params

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
BINS = 5
BIN_MUS = np.linspace(-1.0, 1.0, BINS).astype(np.float32)
LAYOUT = dict(horizon=8, obs_dim=2, act_dim=2, guidance_scale=1.5)
PCFG = PlannerConfig(**LAYOUT)
JPCFG = jpl.PlannerConfig(**LAYOUT)
KW = dict(device="cpu", eps_rel=0.05)


def _fixed_prior(x_init):
    """The port's VP SDE with the reference's prior draw ``x_init``, so
    that both packages start from the same x_T."""

    class FixedPrior(tsde.VPSDE):
        def prior_sample(self, shape, generator):
            assert tuple(shape) == x_init.shape
            return torch.from_numpy(x_init.copy())

    return FixedPrior()


def _reference_inputs(shape, key):
    """The reference's (prior, solver key) of ``sample(..., key)``."""
    k_prior, k_solve = jax.random.split(key)
    return np.asarray(jsde.VPSDE().prior_sample(k_prior, shape)), k_solve


def _small_unet(**kw):
    cfg = dict(horizon=4, transition_dim=4, base=8, mults=(1, 2), t_dim=16, groups=4,
               **kw)
    return ttu.TemporalUNetConfig(**cfg)


# ---------------------------------------------------------------- the UNet


@pytest.mark.parametrize("mults,H", [((1,), 4), ((1, 2), 8), ((1, 2, 4), 16)])
def test_temporal_unet_forward_shapes_and_depths(mults, H):
    cfg = ttu.TemporalUNetConfig(horizon=H, transition_dim=5, base=8, mults=mults,
                                 t_dim=16, groups=4)
    model = ttu.init_temporal_unet(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(3, H, 5, generator=torch.Generator().manual_seed(1))
    out = model(x, torch.full((3,), 0.4))
    assert out.shape == x.shape and out.dtype == torch.float32


def test_temporal_unet_rejects_indivisible_horizon():
    with pytest.raises(ValueError):
        ttu.TemporalUNetConfig(horizon=6, transition_dim=4, mults=(1, 2, 4))
    with pytest.raises(ValueError):
        ttu.TemporalUNetConfig(base=32, attention=True, attn_heads=3)


def test_temporal_unet_policy_dtypes():
    """Compute dtype through the blocks, the score in the state dtype."""
    cfg = _small_unet()
    model = ttu.liven_zero_init(ttu.init_temporal_unet(cfg, torch.Generator().manual_seed(0)),
                                torch.Generator().manual_seed(1))
    x = torch.randn(2, 4, 4, generator=torch.Generator().manual_seed(2))
    t = torch.full((2,), 0.3)
    pol = resolve_policy("bf16")
    assert model(x, t, policy=pol).dtype == torch.bfloat16
    assert ttu.make_score_fn(model, tsde.VPSDE(), policy=pol)(x, t).dtype == torch.float32
    full = resolve_policy("bf16_full")
    assert ttu.make_score_fn(model, tsde.VPSDE(), policy=full)(x, t).dtype == torch.bfloat16


def test_temporal_unet_null_row_bitwise_unconditional():
    """The returns table's null row is zero, so a null-labelled forward is
    bitwise the unconditional one; a real bin changes the field."""
    cfg = _small_unet(returns_bins=BINS)
    model = ttu.init_temporal_unet(cfg, torch.Generator().manual_seed(0))
    ttu.liven_zero_init(model, torch.Generator().manual_seed(1))
    x = torch.randn(3, 4, 4, generator=torch.Generator().manual_seed(2))
    t = torch.full((3,), 0.5)
    out_u = model(x, t)
    assert torch.equal(out_u, model(x, t, y=torch.full((3,), -1, dtype=torch.int32)))
    assert not torch.equal(out_u, model(x, t, y=torch.zeros(3, dtype=torch.int32)))


# ------------------------------------------------------ plan conditioning


def test_plan_conditioner_factory_cases():
    obs, labels = torch.ones(3, 2), torch.arange(3)
    assert plan_conditioner(PCFG) == (None, None)
    c, p = plan_conditioner(PCFG, state=obs)
    assert type(c) is Inpaint and set(p) == {"mask", "observed"}
    c, p = plan_conditioner(PCFG, returns=labels)
    assert type(c) is ClassifierFree and set(p) == {"label"} and c.scale == 1.5
    c, p = plan_conditioner(PCFG, state=obs, returns=labels)
    assert isinstance(c, PlanConditioner) and c.has_projection
    assert set(p) == {"label", "mask", "observed"} and p["label"].dtype == torch.int32
    # the payload is the reference's, leaf for leaf
    _, jp = jpl.plan_conditioner(JPCFG, state=jnp.ones((3, 2)), returns=jnp.arange(3))
    for k in jp:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    neutral = c.neutral_cond(3, PCFG.sample_shape)
    assert (neutral["label"] < 0).all() and not neutral["mask"].any()
    assert {k: tuple(v.shape) for k, v in c.cond_struct(3, PCFG.sample_shape).items()} == \
        {k: tuple(v.shape) for k, v in p.items()}


def test_plan_conditioner_projection_is_inpaint():
    sde = tsde.VPSDE()
    c, p = plan_conditioner(PCFG, state=0.3 * torch.ones(2, 2), returns=torch.arange(2))
    x = torch.randn((2,) + PCFG.sample_shape, generator=torch.Generator().manual_seed(0))
    z = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([0.7, 0.2])
    assert torch.equal(c.project(sde, x, t, p, z), Inpaint().project(sde, x, t, p, z))
    assert torch.equal(c.finalize_project(x, p), Inpaint().finalize_project(x, p))


def test_returns_cfg_scale0_bitwise_unconditional():
    sde = tsde.VPSDE()
    pcfg = dataclasses.replace(PCFG, guidance_scale=0.0)
    shape = (4,) + pcfg.sample_shape
    res_u = sample(sde, tan.gaussian_score(sde, MU, S0), shape, seed=0, **KW)
    conditioner, cond = plan_conditioner(pcfg, returns=torch.arange(4) % BINS)
    res_c = sample(sde, tan.class_gaussian_score(sde, BIN_MUS, S0, MU), shape, seed=0,
                   conditioner=conditioner, cond=cond, **KW)
    assert torch.equal(res_u.x, res_c.x) and torch.equal(res_u.nfe, res_c.nfe)


def test_state_mask_none_bitwise_unconditional():
    sde = tsde.VPSDE()
    score = tan.gaussian_score(sde, MU, S0)
    res_u = sample(sde, score, (4,) + PCFG.sample_shape, seed=0, **KW)
    res_p = plan(sde, score, None, 0, pcfg=PCFG, batch=4, **KW)
    assert torch.equal(res_u.x, res_p.x)
    with pytest.raises(ValueError, match="batch"):
        plan(sde, score, None, 0, pcfg=PCFG, **KW)
    with pytest.raises(ValueError, match="disagrees"):
        plan(sde, score, torch.zeros(3, 2), 0, pcfg=PCFG, batch=4, **KW)


def test_plan_pins_state_exactly_and_free_region_on_marginal():
    sde = tsde.VPSDE()
    score = tan.class_gaussian_score(sde, BIN_MUS, S0, MU)
    obs = torch.tensor([[0.1, -0.2], [0.4, 0.0], [-0.3, 0.25], [0.05, 0.6]])
    res = plan(sde, score, obs, 0, pcfg=PCFG, returns=torch.arange(4) % BINS, **KW)
    assert torch.equal(res.x[:, 0, :2], obs)
    assert first_action(res.x, PCFG).shape == (4, 2)
    free = res.x[:, 1:, :]
    assert abs(float(free.mean())) < 1.0 and torch.isfinite(free).all()


def test_first_action_selects_action_columns():
    x = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
    assert torch.equal(first_action(x, PCFG), x[:, 0, 2:4])


def test_returns_to_bin_and_state_pin_shapes():
    bins = returns_to_bin(torch.tensor([-2.0, 0.0, 2.0]), -1.0, 1.0, BINS)
    assert bins.tolist() == [0, 2, BINS - 1] and bins.dtype == torch.int32
    pin = state_pin(PCFG, torch.ones(2, 2))
    assert pin["mask"].shape == (2,) + PCFG.sample_shape
    assert float(pin["mask"].sum()) == 2 * PCFG.context * PCFG.obs_dim
    with pytest.raises(ValueError):
        state_pin(PCFG, torch.ones(2, 3))


def test_chunked_plan_bitwise_equals_monolithic_with_payload():
    sde = tsde.VPSDE()
    score = tan.class_gaussian_score(sde, BIN_MUS, S0, MU)
    obs = 0.2 * torch.ones(3, 2)
    conditioner, cond = plan_conditioner(PCFG, state=obs, returns=torch.arange(3) % BINS)
    cfg = AdaptiveConfig(eps_rel=0.05, conditioner=conditioner)
    shape = (3,) + PCFG.sample_shape
    mono = solve_in_chunks(sde, score, shape, max_sync_iters=10**6, config=cfg, cond=cond,
                           seed=2, device="cpu")
    chunk = solve_in_chunks(sde, score, shape, max_sync_iters=7, config=cfg, cond=cond,
                            seed=2, device="cpu")
    assert torch.equal(mono.x, chunk.x) and torch.equal(mono.nfe, chunk.nfe)
    assert torch.equal(mono.x[:, 0, :2], obs)


# --------------------------------------------------- plan() vs reference


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_plan_matches_reference_analytic(fused):
    obs = (0.3 * np.random.default_rng(0).standard_normal((4, 2))).astype(np.float32)
    ret = (np.arange(4) % BINS).astype(np.int32)
    key = jax.random.PRNGKey(0)
    js = jsde.VPSDE()
    want = jpl.plan(js, jan.class_gaussian_score(js, BIN_MUS, S0, MU), jnp.asarray(obs),
                    key, pcfg=JPCFG, returns=jnp.asarray(ret), eps_rel=0.05)
    x0, k_solve = _reference_inputs((4,) + JPCFG.sample_shape, key)
    ts = _fixed_prior(x0)
    got = plan(ts, tan.class_gaussian_score(ts, BIN_MUS, S0, MU), torch.from_numpy(obs),
               pcfg=PCFG, returns=torch.from_numpy(ret), noise_fn=ReferenceNoise(k_solve),
               use_fused_kernel=fused, **KW)
    _assert_same_solve(got, want)
    assert int(got.rejected.sum()) > 0
    np.testing.assert_array_equal(got.x[:, 0, :2].numpy(), obs)


def test_plan_matches_reference_temporal_unet():
    """``plan()`` through the small livened temporal UNet, returns CFG at
    1.5 and the state pin: the port runs its fused GroupNorm, flash
    attention and fused step routes (their plain versions on the CPU),
    the reference its jnp paths."""
    jcfg = jtu.TemporalUNetConfig(horizon=8, transition_dim=4, base=8, mults=(1, 2),
                                  t_dim=16, groups=4, returns_bins=3, attention=True,
                                  attn_heads=2)
    tcfg = dataclasses.replace(ttu.TemporalUNetConfig(**dataclasses.asdict(jcfg)),
                               use_flash=True, use_fused_norm=True)
    tree = reference_params(jcfg)
    js = jsde.VPSDE()
    jscore = jtu.make_score_fn(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, js)
    obs = np.array([[0.2, -0.1], [0.0, 0.3], [-0.4, 0.1]], np.float32)
    ret = np.array([0, 2, -1], np.int32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda o, r, k: jpl.plan(
        js, jscore, o, k, pcfg=JPCFG, returns=r,
        config=JConfig(eps_rel=0.05, use_fused_kernel=False)))(
            jnp.asarray(obs), jnp.asarray(ret), key)
    x0, k_solve = _reference_inputs((3,) + JPCFG.sample_shape, key)
    ts = _fixed_prior(x0)
    model = ttu.params_from_jax(tree, tcfg)
    got = plan(ts, ttu.make_score_fn(model, ts), torch.from_numpy(obs), pcfg=PCFG,
               returns=torch.from_numpy(ret), noise_fn=ReferenceNoise(k_solve),
               config=AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True), device="cpu")
    _assert_same_solve(got, want)
    np.testing.assert_array_equal(got.x[:, 0, :2].numpy(), obs)
    assert torch.isfinite(got.x).all()


def test_reference_fused_step_reads_past_padded_d_at_traj_width():
    """Why the parity tests run the reference's jnp step: at TRAJ_UNET's
    D = 32 × 23 = 736 (padded to 768, tiled by 512) the reference's
    fused kernel in interpret mode reads past the array and gives NaN;
    the port's step (its plain version here) is finite."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 23)).astype(np.float32)
    xp = (1.01 * x).astype(np.float32)
    c = np.full((4,), 0.01, np.float32)
    args = (x, xp, x, x, x, c, c, c)
    _, e2_ref = jstep.error_step(*map(jnp.asarray, args), eps_abs=0.0078, eps_rel=0.05)
    assert np.isnan(np.asarray(e2_ref)).all()
    _, e2 = tstep.error_step(*map(torch.from_numpy, args), eps_abs=0.0078, eps_rel=0.05)
    assert torch.isfinite(e2).all()
