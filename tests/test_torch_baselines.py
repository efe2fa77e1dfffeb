"""Port ↔ reference parity: the paper's baseline solvers (EM, the
reverse-diffusion predictor with a Langevin or HMC corrector, DDIM and
the probability-flow RK45) and their NFE accounting.

Each port solver runs on the same x_init as its reference function and
is handed the reference's own noise through its ``noise_fn`` seam
(``ReferenceNoise`` replays ``key, sub = split(key); normal(sub)`` once
per draw: once per EM step; once per corrector pass and once for the
predictor in PC; never in DDIM and the ODE). What must agree:

* the times the score network is asked at, bit for bit, for the fixed
  grids (EM's T − i·h, PC's and DDIM's ``linspace``): both sides record
  every ``t`` their score function receives;
* ``nfe`` and ``iterations`` exactly;
* the samples: fp32 rtol 1e-5 with atol 1e-5·max|x| for the fixed grids
  on the closed-form score. K5 distributes h where the reference
  computes x − h·drift, and XLA fuses products and sums into one
  multiply-add where torch rounds each, so the two differ by a few fp32
  ulps a step (measured ≤ 1e-6·max|x| over ≤ 50 steps). Through the
  livened DiT: rtol 1e-4 with atol 1e-5·max|x|, the bound of the
  adaptive solve through the same network (tests/test_torch_adaptive.py).
* ODE samples: the reference's error estimate x5 − x4 sits below an fp32
  ulp of x in its first attempts, so its step sizes carry rounding noise
  of a few percent, and two RK45 solves that round differently take
  slightly different steps. The bound is four times how far the
  reference's own output moves when x_init moves by one ulp (both
  directions), plus 1e-5·max|x|.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as jan
from repro.core import sde as jsde
from repro.models import dit as jdit
from repro_torch.core import analytic as tan
from repro_torch.core import sde as tsde
from repro_torch.core.sampling import sample
from repro_torch.core.solvers import (
    available_solvers, get_solver, solver_nfe_per_iteration,
)
from repro_torch.core.solvers import base as tbase
from repro_torch.core.solvers.euler_maruyama import em_times
from repro_torch.core.solvers.predictor_corrector import linspace_f32
from repro_torch.kernels.solver_step import ops as step_ops
from repro_torch.models import dit as tdit

from test_torch_adaptive import ReferenceNoise, _prior
from test_torch_dit import reference_params

jsolvers = importlib.import_module("repro.core.solvers")

torch.set_num_threads(2)

SDES = {"vp": (jsde.VPSDE(), tsde.VPSDE()),
        "ve": (jsde.VESDE(sigma_max=10.0), tsde.VESDE(sigma_max=10.0)),
        "subvp": (jsde.SubVPSDE(), tsde.SubVPSDE())}

REFERENCE = {"em": jsolvers.euler_maruyama, "pc": jsolvers.predictor_corrector,
             "pc_hmc": jsolvers.predictor_corrector_hmc, "ddim": jsolvers.ddim,
             "ode": jsolvers.probability_flow_rk45}

#: (solver, sde, kwargs): the closed-form Gaussian score, n_steps ≤ 50.
#: VP PC grids keep n_steps > β_max = 20: below it the reference's Langevin
#: α = 1 − β(t)/N turns negative and its step √(2ε) is NaN.
CASES = [
    ("em", "vp", dict(n_steps=50)),
    ("em", "ve", dict(n_steps=50)),
    ("em", "subvp", dict(n_steps=40)),
    ("pc", "vp", dict(n_steps=25)),
    ("pc", "ve", dict(n_steps=25)),
    ("pc", "ve", dict(n_steps=12, corrector_steps=2, snr=0.1)),
    ("pc_hmc", "vp", dict(n_steps=30)),
    ("pc_hmc", "ve", dict(n_steps=20, hmc_leapfrog=2)),
    ("ddim", "vp", dict(n_steps=50)),
    ("ddim", "subvp", dict(n_steps=30)),
    ("ode", "vp", dict(rtol=1e-3, atol=1e-3)),
    ("ode", "ve", dict(rtol=1e-3, atol=1e-3)),
]


def _recording_jax(score, log):
    def f(x, t):
        jax.debug.callback(lambda tt: log.append(np.array(tt)), t, ordered=True)
        return score(x, t)

    return f


def _recording_torch(score, log):
    def f(x, t):
        log.append(t.numpy().copy())
        return score(x, t)

    return f


def _reference(method, js, score, x0, key, **kw):
    log = []
    res = REFERENCE[method](js, _recording_jax(score, log), jnp.asarray(x0), key, **kw)
    jax.effects_barrier()
    return res, log


def _port(method, ts, score, x0, key, **kw):
    log = []
    res = get_solver(method)(ts, _recording_torch(score, log), torch.from_numpy(x0),
                             noise_fn=ReferenceNoise(key), device="cpu", **kw)
    return res, log


def _assert_counts(got, want):
    np.testing.assert_array_equal(got.nfe.numpy(), np.asarray(want.nfe))
    assert int(got.iterations) == int(want.iterations)
    assert not got.accepted.any() and not got.rejected.any()


@pytest.mark.parametrize("method,sde_name,kw", CASES,
                         ids=[f"{m}-{s}-{'-'.join(map(str, k.values()))}"
                              for m, s, k in CASES])
def test_solver_matches_reference(method, sde_name, kw):
    js, ts = SDES[sde_name]
    x0 = _prior((16, 8)) * ts.prior_std()
    key = jax.random.PRNGKey(3)
    jscore, tscore = jan.gaussian_score(js), tan.gaussian_score(ts)
    want, want_t = _reference(method, js, jscore, x0, key, **kw)
    got, got_t = _port(method, ts, tscore, x0, key, **kw)
    _assert_counts(got, want)
    want_x = np.asarray(want.x)
    scale = max(1.0, float(np.abs(want_x).max()))
    if method == "ode":
        # the solves see the same times up to the first step-size update
        assert all(np.array_equal(a, b) for a, b in zip(want_t[:7], got_t[:7]))
        moved = max(
            np.abs(np.asarray(REFERENCE[method](
                js, jscore, jnp.asarray(np.nextafter(x0, np.float32(d))), key, **kw).x)
                - want_x).max() for d in (np.inf, -np.inf))
        np.testing.assert_allclose(got.x.numpy(), want_x, rtol=0,
                                   atol=4 * moved + 1e-5 * scale)
        return
    assert len(got_t) == len(want_t)
    for i, (a, b) in enumerate(zip(want_t, got_t)):
        np.testing.assert_array_equal(b, a, err_msg=f"score call {i}")
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("n_steps", [1, 2, 7, 25, 50, 100, 1000])
@pytest.mark.parametrize("sde_name", ["vp", "ve"])
def test_em_grid_is_the_reference_grid_bitwise(sde_name, n_steps):
    """The reference's t_i = T − i·h inside its scan, as its XLA code
    rounds it."""
    js, ts = SDES[sde_name]
    h = (js.T - js.t_eps) / n_steps
    want = jax.lax.scan(lambda c, i: (c, jnp.full((1,), js.T - i * h)), None,
                        jnp.arange(n_steps))[1][:, 0]
    got = em_times(ts, n_steps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num", range(2, 52))
@pytest.mark.parametrize("t_eps", [1e-3, 1e-5])
def test_linspace_is_jnp_linspace_bitwise(t_eps, num):
    """PC's and DDIM's grid: ``jnp.linspace(T, t_eps, N + 1)`` in fp32 for
    every N ≤ 50."""
    got = linspace_f32(1.0, t_eps, num)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.linspace(1.0, t_eps, num)))


def test_slice_through_the_livened_dit():
    """EM and PC from a small livened DiT (2 layers, width 96) with the
    reference's weights carried over by ``params_from_jax``, against the
    reference solvers on the same weights, x_init and noise."""
    jcfg = jdit.DiTConfig(image_size=16, patch=4, d_model=96, num_layers=2,
                          num_heads=4, d_ff=256)
    tcfg = tdit.DiTConfig(image_size=16, patch=4, d_model=96, num_layers=2,
                          num_heads=4, d_ff=256, use_flash=True)
    tree = reference_params(jcfg)
    js, ts = SDES["vp"]
    jscore = jdit.make_score_fn(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, js)
    tscore = tdit.make_score_fn(tdit.params_from_jax(tree, tcfg), ts)
    x0 = _prior((3, 16, 16, 3), seed=1)
    key = jax.random.PRNGKey(5)
    for method, kw in (("em", dict(n_steps=12)), ("pc", dict(n_steps=21))):
        fn = REFERENCE[method]
        want = jax.jit(lambda x, k: fn(js, jscore, x, k, **kw))(jnp.asarray(x0), key)
        got = get_solver(method)(ts, tscore, torch.from_numpy(x0),
                                 noise_fn=ReferenceNoise(key), device="cpu", **kw)
        _assert_counts(got, want)
        want_x = np.asarray(want.x)
        assert float(np.abs(want_x).mean()) > 1e-2
        np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(want_x).max())))


# -------------------------------------------------- NFE accounting
# mirrors of tests/test_nfe_accounting.py

B, D = 16, 8
NFE_CASES = {
    "em": (dict(n_steps=50), {}),
    "ddim": (dict(n_steps=25), {}),
    "adaptive": (dict(eps_rel=0.05), {}),
    "momentum": (dict(eps_rel=0.05, momentum=0.15), {}),
    "heun": (dict(eps_rel=0.05, probability_flow=True), {}),
    "ode": ({}, {}),
    "pc": (dict(n_steps=30, corrector_steps=2), dict(corrector_steps=2)),
    "pc_hmc": (dict(n_steps=30, corrector_steps=1, hmc_leapfrog=3),
               dict(corrector_steps=1, hmc_leapfrog=3)),
}


def test_every_registered_solver_has_an_accounting_case():
    assert available_solvers() == sorted(NFE_CASES)


@pytest.mark.parametrize("method", list(NFE_CASES))
def test_registry_rule_matches_measured_nfe(method):
    kwargs, rule_kwargs = NFE_CASES[method]
    per_iter = solver_nfe_per_iteration(method, **rule_kwargs)
    ts = tsde.VPSDE()
    res = sample(ts, tan.gaussian_score(ts), (B, D), seed=0, method=method,
                 denoise=False, device="cpu", **kwargs)
    if method in ("adaptive", "momentum", "heun"):
        assert torch.equal(res.nfe, per_iter * (res.accepted + res.rejected))
        assert int((res.accepted + res.rejected).max()) <= int(res.iterations)
    else:
        assert int(res.nfe.min()) == int(res.nfe.max())
        seed_evals = 1 if method == "ode" else 0  # rk45's FSAL seed
        assert int(res.nfe[0]) == per_iter * int(res.iterations) + seed_evals


def test_rule_values_track_configuration():
    rule = solver_nfe_per_iteration
    assert (rule("em"), rule("ddim"), rule("adaptive"), rule("ode")) == (1, 1, 2, 6)
    assert rule("pc") == 2 and rule("pc", corrector_steps=3) == 4
    assert rule("pc_hmc") == rule("pc", corrector="hmc")
    assert rule("pc_hmc", corrector_steps=2, hmc_leapfrog=5) == 11
    assert rule("em", n_steps=999) == 1


def test_unknown_or_undeclared_solver_raises(monkeypatch):
    with pytest.raises(ValueError, match="unknown solver"):
        solver_nfe_per_iteration("not_a_solver")
    monkeypatch.setitem(tbase._REGISTRY, "_norule", lambda: None)
    with pytest.raises(ValueError, match="no per-iteration NFE rule"):
        solver_nfe_per_iteration("_norule")


def test_ve_fixed_grid_accounting():
    ts = tsde.VESDE(sigma_max=10.0)
    res = sample(ts, tan.gaussian_score(ts), (B, D), seed=0, method="pc",
                 n_steps=20, corrector_steps=2, denoise=False, device="cpu")
    assert int(res.nfe[0]) == solver_nfe_per_iteration("pc", corrector_steps=2) * 20


# -------------------------------------------------- K5 on the path

@pytest.mark.parametrize("method,kw,per_step", [
    ("em", dict(n_steps=9), 1),
    ("pc", dict(n_steps=9), 2),
    ("pc", dict(n_steps=9, corrector_steps=3), 4),
    ("pc_hmc", dict(n_steps=9), 1),
    ("ddim", dict(n_steps=9), 0),
    ("ode", {}, 0),
    ("adaptive", dict(eps_rel=0.05), 0),
])
def test_updates_go_through_k5(monkeypatch, method, kw, per_step):
    """Every EM step, ancestral predictor and Langevin corrector calls the
    K5 wrapper (the kernel on the card, ``ref.em_step`` here); the HMC
    leapfrog, DDIM, the ODE and Algorithm 1 do not."""
    calls = []
    inner = step_ops.em_step
    monkeypatch.setattr(step_ops, "em_step",
                        lambda *a: calls.append(a[0].shape) or inner(*a))
    ts = tsde.VPSDE()
    sample(ts, tan.gaussian_score(ts), (4, 6), seed=0, method=method,
           device="cpu", **kw)
    assert len(calls) == per_step * kw.get("n_steps", 0)


# -------------------------------------------------- API contracts

def test_ddim_is_vp_only():
    ts = tsde.VESDE()
    with pytest.raises(TypeError, match="VP"):
        get_solver("ddim")(ts, tan.gaussian_score(ts), torch.zeros(2, 3), device="cpu")


def test_unknown_corrector_raises():
    ts = tsde.VPSDE()
    with pytest.raises(ValueError, match="unknown corrector"):
        get_solver("pc")(ts, tan.gaussian_score(ts), torch.zeros(2, 3),
                         torch.Generator(), corrector="mala", device="cpu")


@pytest.mark.parametrize("method", ["em", "pc", "pc_hmc"])
def test_stochastic_solvers_need_a_noise_source(method):
    ts = tsde.VPSDE()
    with pytest.raises(ValueError, match="generator or a noise_fn"):
        get_solver(method)(ts, tan.gaussian_score(ts), torch.zeros(2, 3), device="cpu")


@pytest.mark.parametrize("method", ["adaptive", "em", "pc", "pc_hmc", "ddim", "ode"])
def test_sample_runs_every_method_from_one_generator(method):
    """``sample(method=m)`` on the CPU: the prior and every noise draw come
    from the seed's per-row streams, so the seed fixes the result."""
    ts = tsde.VPSDE()
    kw = {"adaptive": dict(eps_rel=0.05), "ode": {}}.get(method, dict(n_steps=30))
    runs = [sample(ts, tan.gaussian_score(ts), (8, 5), seed=s, method=method,
                   device="cpu", **kw) for s in (4, 4, 5)]
    a, b, c = runs
    assert a.x.shape == (8, 5) and torch.isfinite(a.x).all()
    assert torch.equal(a.x, b.x) and torch.equal(a.nfe, b.nfe)
    assert not torch.equal(a.x, c.x)


# -------------------------------------------------- the Table-2 analog

def test_frechet_gaussian_matches_the_reference_helper():
    from benchmarks.common import frechet_gaussian as reference_frechet
    from repro_torch.benchmarks.table2_highdim import frechet_gaussian

    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 8)) * rng.uniform(0.2, 2.0, 8)
    y = rng.standard_normal((64, 8)) + 0.3
    assert frechet_gaussian(x, y) == pytest.approx(reference_frechet(x, y), rel=1e-12)


def test_table2_runs_every_row_small():
    """The benchmark's rows at a small size on the CPU (the card runs it at
    D = 3072, N = 256): every row finite, the fixed grids' NFE exact, and
    each matched EM row spends the adaptive row's NFE."""
    from repro_torch.benchmarks import table2_highdim as t2

    rows = t2.run("cpu", n=16, d=32)
    names = [r["name"].split("/")[-1] for r in rows]
    assert names[:3] == ["reverse-langevin", "em-2000", "prob-flow-ode"]
    assert names[3:] == [f"{k}-eps{e}" for e in t2.EPS_RELS for k in ("ours", "em-match")]
    assert all(r["finite"] and np.isfinite(r["frechet8"]) for r in rows)
    assert rows[0]["nfe"] == 2001 and rows[1]["nfe"] == 2001
    for ours, em in zip(rows[3::2], rows[4::2]):
        assert em["nfe"] == max(int(ours["nfe"]), 2) + 1
