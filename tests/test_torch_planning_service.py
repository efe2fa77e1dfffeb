"""Port ↔ reference parity: the receding-horizon planner served through
the batcher (``repro_torch.planning.RecedingHorizonPlanner``), its
analytic environments (``planning/envs.py``) and launchers
(``launch/plan.py``, ``launch/serve.py --plan``).

  * **parity**: the reference's closed loop and the port's on the same
    draws. The port is handed the reference's per-request streams
    (``ReferenceStreams``, the batcher's ``request_streams`` seam) and
    its environment draws (``EnvReplay``: the resets from
    ``split(key, n_envs + 1)[1:]``, then each step's from the chained
    ``split`` of the first key, as ``rollout`` draws). Per-request NFE,
    the uids delivered, the iterations and the waste books exactly equal;
    plans within rtol 1e-4 and an absolute 1e-5 of the largest |x| (as
    in ``test_torch_diffusion_server.py``), rewards within 1e-5.
  * **mirrors** of ``tests/test_planning.py``'s closed-loop rows on the
    port's own RNG: plans pin their state exactly; re-admission is
    bitwise invariant across sync horizons and compaction, with more
    environments than slots; each delivered plan is bitwise its
    standalone ``adaptive()``; mismatched environment dims are refused;
    returns guidance steers the reward (bin 2 above bin 4 on OU).
  * the device-resident batcher (its plain driver here) drains the same
    plan requests bitwise; ``solver=`` names the config's family and
    sets the books' rate; the launchers run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import VPSDE as JVPSDE
from repro.core.analytic import class_gaussian_noise_pred as jclass_noise_pred
from repro.planning import envs as jenvs
from repro.planning import planner as jpl
from repro_torch.core import analytic as tan
from repro_torch.core.sde import VPSDE, bcast
from repro_torch.core.solvers import solver_nfe_per_iteration
from repro_torch.core.solvers.adaptive import AdaptiveConfig, adaptive
from repro_torch.core.solvers.base import SlotStreams
from repro_torch.launch import plan as tplan
from repro_torch.launch import serve as tserve
from repro_torch.launch.sample import make_sample_step
from repro_torch.planning import (
    ENVS, OUEnv, PlanConditioner, PlannerConfig, PlanRequest, PointMassEnv,
    RecedingHorizonPlanner, get_env,
)
from repro_torch.serving.diffusion_server import DiffusionBatcher

from test_torch_diffusion_server import ReferenceStreams

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
BINS = 5
BIN_MUS = np.linspace(-1.0, 1.0, BINS).astype(np.float32)
LAYOUT = dict(horizon=8, obs_dim=2, act_dim=2, guidance_scale=1.5)
PCFG = PlannerConfig(**LAYOUT)


class EnvReplay:
    """An environment noise source replaying the reference's ``rollout``:
    the first ``n_envs`` draws are the resets, the rest the steps'."""

    def __init__(self, key, n_envs: int):
        keys = jax.random.split(key, n_envs + 1)
        self.resets = list(keys[1:])
        self.step_key = keys[0]

    def __call__(self, shape):
        if self.resets:
            k = self.resets.pop(0)
        else:
            self.step_key, k = jax.random.split(self.step_key)
        return torch.from_numpy(np.array(jax.random.normal(k, shape)))


def _forward(sde):
    f = tan.class_gaussian_noise_pred(sde, BIN_MUS, S0, MU)
    return lambda p, x, t, y=None: f(x, t, y)


def _planner(slots=4, sync_horizon=4, *, compaction=True, env=None, **kw):
    sde = VPSDE()
    return RecedingHorizonPlanner(sde, _forward(sde), None, PCFG, env or OUEnv(obs_dim=2),
                                  slots=slots, sync_horizon=sync_horizon,
                                  compaction=compaction, device="cpu", **kw)


def _rollout(slots, sync_horizon, *, compaction=True, n_envs=4, n_steps=2, label=BINS - 1,
             seed=1):
    rh = _planner(slots, sync_horizon, compaction=compaction)
    return rh, rh.rollout(seed, n_envs=n_envs, n_steps=n_steps, returns_label=label)


def test_closed_loop_matches_reference_on_its_draws():
    jsde = JVPSDE()
    jrh = jpl.RecedingHorizonPlanner(
        jsde, jclass_noise_pred(jsde, jnp.asarray(BIN_MUS), S0, MU), None,
        jpl.PlannerConfig(**LAYOUT), jenvs.OUEnv(obs_dim=2), slots=4, sync_horizon=4)
    want = jrh.rollout(jax.random.PRNGKey(1), n_envs=6, n_steps=2, returns_label=BINS - 1)
    rh = _planner(request_streams=ReferenceStreams(jsde))
    got = rh.rollout(EnvReplay(jax.random.PRNGKey(1), 6), n_envs=6, n_steps=2,
                     returns_label=BINS - 1)
    np.testing.assert_array_equal(got["nfe"], want["nfe"])
    assert list(got["finished"]) == list(want["finished"])  # delivery order
    for key in ("total_iterations", "wasted_nfe_fraction", "passenger_nfe_fraction",
                "refills_per_device"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=0, atol=1e-5)
    for uid, req in want["finished"].items():
        mine = got["finished"][uid]
        x = np.asarray(req.result)
        np.testing.assert_allclose(mine.result, x, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(x).max())))
        assert (mine.accepted, mine.rejected) == (req.accepted, req.rejected)
        m = np.asarray(mine.cond["mask"]) == 1.0
        np.testing.assert_array_equal(mine.result[m], np.asarray(mine.cond["observed"])[m])


@pytest.mark.parametrize("name", sorted(ENVS))
def test_envs_match_reference_given_the_same_draws(name):
    env = get_env(name, **({"dim": 3} if name == "pointmass" else {"obs_dim": 3}))
    jenv = jenvs.get_env(name, **({"dim": 3} if name == "pointmass" else {"obs_dim": 3}))
    assert (env.obs_dim, env.act_dim) == (jenv.obs_dim, jenv.act_dim)
    key = jax.random.PRNGKey(5)
    replay = lambda k: (lambda shape: torch.from_numpy(np.array(jax.random.normal(k, shape))))
    obs, jobs = env.reset(replay(key)), jenv.reset(key)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    rng = np.random.default_rng(0)
    for i in range(4):
        a = rng.standard_normal(env.act_dim).astype(np.float32)
        k = jax.random.fold_in(key, i)
        obs, r = env.step(obs, torch.from_numpy(a), replay(k))
        jobs, jr = jenv.step(jobs, jnp.asarray(a), k)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        assert r == pytest.approx(jr, rel=1e-6, abs=1e-7)
    with pytest.raises(ValueError):
        get_env("cartpole")
    # the torch.Generator form draws from the port's own RNG
    g = torch.Generator().manual_seed(0)
    assert env.reset(g).shape == (env.obs_dim,)


def test_closed_loop_plans_pin_and_progress():
    """Mirror of ``test_closed_loop_smoke_plans_pin_and_progress``."""
    rh, out = _rollout(slots=4, sync_horizon=4, n_envs=3, n_steps=2)
    assert out["rewards"].shape == (2, 3)
    assert np.isfinite(out["rewards"]).all()
    assert (out["nfe"] > 10).all() and (out["nfe"] % 2 == 0).all()
    for req in out["finished"].values():
        m = np.asarray(req.cond["mask"]) == 1.0
        np.testing.assert_array_equal(np.asarray(req.result)[m],
                                      np.asarray(req.cond["observed"])[m])


def test_closed_loop_readmission_invariant_to_scheduling():
    """Mirror of ``test_closed_loop_readmission_invariant_to_scheduling``:
    6 environments on 4 slots, sync horizons 1 and 8, compaction on and
    off, the same plans bit for bit and the same NFE."""
    outs = [_rollout(slots=4, sync_horizon=h, compaction=c, n_envs=6)[1]
            for h, c in ((1, True), (8, True), (8, False))]
    assert outs[0]["finished"].keys() == outs[1]["finished"].keys() == outs[2]["finished"].keys()
    for uid in outs[0]["finished"]:
        r = [o["finished"][uid] for o in outs]
        assert np.array_equal(r[0].result, r[1].result) and np.array_equal(r[1].result,
                                                                           r[2].result)
        assert r[0].nfe == r[1].nfe == r[2].nfe
    np.testing.assert_array_equal(outs[0]["rewards"], outs[2]["rewards"])


def test_closed_loop_request_reproducible_standalone():
    """Mirror of ``test_closed_loop_request_reproducible_standalone``, with
    seatmates: every delivered plan is bitwise a batch-1 ``adaptive()`` of
    its (seed, payload) on its own stream, with its NFE."""
    sde = VPSDE()
    rh, out = _rollout(slots=4, sync_horizon=4, n_envs=5, n_steps=2)
    fwd = _forward(sde)

    def score_fn(x, t, y=None):  # make_sample_step's wrapping
        return -fwd(None, x, t, y) / bcast(sde.marginal(t)[1], x)

    assert len(out["finished"]) == 10
    for uid, req in sorted(out["finished"].items()):
        x0 = sde.prior_sample((1,) + PCFG.sample_shape,
                              SlotStreams.of([req.seed], 0, device="cpu"))
        cond = {k: torch.as_tensor(v)[None] for k, v in req.cond.items()}
        res = adaptive(sde, score_fn, x0, SlotStreams.of([req.seed], 1, device="cpu"),
                       config=rh.cfg, cond=cond, denoise=False, device="cpu")
        x = rh.cfg.conditioner.finalize_project(res.x, cond)
        assert np.array_equal(x[0].numpy(), req.result), uid
        assert int(res.nfe[0]) == req.nfe


def test_planner_rejects_mismatched_env_dims():
    with pytest.raises(ValueError):
        _planner(env=OUEnv(obs_dim=3))
    rh = _planner(cfg=AdaptiveConfig(eps_rel=0.05, conditioner=PlanConditioner(scale=1.0)))
    assert set(rh.request_cond(torch.zeros(2), 1)) == {"label", "mask", "observed"}
    from repro_torch.core.guidance import Inpaint

    rh = _planner(cfg=AdaptiveConfig(eps_rel=0.05, conditioner=Inpaint()))
    with pytest.raises(ValueError):
        rh.request_cond(torch.zeros(2), 1)  # a label the conditioner cannot carry


def test_returns_guidance_steers_reward():
    """The reference's steering gate (``tests/test_planning.py``'s slow
    e2e test): on OU, bin 2 (μ = 0, small actions) earns more than bin 4
    (large positive actions)."""
    reward = {label: float(_rollout(4, 4, n_envs=4, n_steps=4, label=label, seed=4)[1]
                           ["rewards"].mean()) for label in (2, 4)}
    assert reward[2] > reward[4], reward


def test_device_resident_drain_bitwise_host_driven():
    """The plan requests of one round through a device-resident batcher
    (the plain driver here; a WHILE-node graph on the card) with the same
    cfg and conditioner: the same deliveries bit for bit, the same NFE."""
    sde = VPSDE()
    rh, out = _rollout(slots=4, sync_horizon=4, n_envs=6, n_steps=1)
    srv = DiffusionBatcher(sde, make_sample_step(sde, rh.cfg, forward_fn=_forward(sde)), None,
                           PCFG.sample_shape, slots=4, cfg=rh.cfg, sync_horizon=4,
                           device="cpu", device_resident=True)
    for uid, req in out["finished"].items():
        srv.submit(PlanRequest(uid=uid, seed=req.seed, cond=req.cond))
    done = srv.run_to_completion()
    assert done.keys() == out["finished"].keys()
    for uid, req in out["finished"].items():
        assert np.array_equal(done[uid].result, req.result) and done[uid].nfe == req.nfe
    assert srv.host_transfers < rh.batcher.host_transfers


def test_server_books_take_the_registry_rate():
    """The books take the registry's rate of the family the step's config
    runs; a ``solver`` of another family, or none, is refused."""
    sde = VPSDE()
    for solver, fields in (("momentum", dict(momentum=0.15)),
                           ("heun", dict(probability_flow=True)), ("adaptive", {})):
        cfg = AdaptiveConfig(**fields)
        step = make_sample_step(sde, cfg, forward_fn=_forward(sde))
        b = DiffusionBatcher(sde, step, None, (4,), slots=2, cfg=cfg, device="cpu",
                             solver=solver)
        assert b.nfe_per_iter == solver_nfe_per_iteration(solver) == 2
        for other in ("pc_hmc", "nope", *{"momentum", "heun", "adaptive"} - {solver}):
            with pytest.raises(ValueError):
                DiffusionBatcher(sde, step, None, (4,), slots=2, cfg=cfg, device="cpu",
                                 solver=other, solver_kwargs={})


def test_serve_planning_launchers_on_the_cpu():
    rec = tplan.serve_planning(envs=3, steps=2, device="cpu")
    for key in ("env", "envs", "steps", "slots", "sync_horizon", "compaction", "score",
                "cfg_scale", "plans", "plans_per_sec", "mean_nfe", "mean_reward",
                "final_round_reward", "wasted_nfe_fraction", "passenger_nfe_fraction",
                "refills_per_device"):
        assert key in rec, key
    assert rec["plans"] == 6 and np.isfinite(rec["mean_reward"])
    rec = tserve.main(["--plan", "--device", "cpu", "--envs", "2", "--plan-steps", "1",
                       "--plan-env", "pointmass", "--unet", "--cfg-scale", "1.5"])
    assert rec["score"] == "temporal_unet" and rec["plans"] == 2
    rec = tplan.main(["--device", "cpu", "--envs", "2", "--steps", "1", "--unet",
                      "--unet-attention", "--fused-norm", "--env", "pointmass",
                      "--compare-em", "20"])
    assert rec["compare_em"]["em_nfe"] == 21 and np.isfinite(rec["mean_reward"])
    assert isinstance(PointMassEnv().reset(torch.Generator().manual_seed(0)), torch.Tensor)
