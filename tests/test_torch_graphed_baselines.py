"""The paper's baselines as graphed loops, on the CPU: EM, PC, PC-HMC and
DDIM on a fixed grid (``core.solvers.grid``) and the probability-flow RK45
(``core.solvers.probability_flow``), each through the cached driver
(``adaptive.solve_cached``; on the CPU the plain driver,
``kernels.graph_loop.ref``) against the host-driven loop fed the same
``SlotStreams`` draws through ``noise_fn``: x, nfe and iterations bit for
bit. Also the one-shot rule (a key's first solve host-driven, the second
builds the driver, later ones reuse it), the per-solve values a key leaves
out (``n_steps``, the ODE's tolerances, Algorithm 1's eps_rel), and
``sample(method="em"|"pc")`` on its streams against the reference fed the
same draws. The card's WHILE node, its one host read a solve and the
launch counts are gated in ``chip_smoke.py`` phase 4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as jan
from repro.core import sde as jsde
from repro.core.solvers import euler_maruyama as reference_em
from repro.core.solvers import predictor_corrector as reference_pc
from repro_torch.core import analytic as tan
from repro_torch.core import sde as tsde
from repro_torch.core.sampling import sample, seed_streams
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers import get_solver
from repro_torch.core.solvers import grid
from repro_torch.core.solvers.euler_maruyama import em_times
from repro_torch.core.solvers.predictor_corrector import linspace_f32
from repro_torch.kernels.graph_loop import ref as loop_ref

torch.set_num_threads(2)

SHAPE = (16, 8)
FIELDS = ("x", "nfe", "iterations")
#: (method, sde, kwargs): VP PC grids keep n_steps > β_max = 20 (below it the
#: discrete β_i passes 1 and the predictor's √(1 − β_i) is NaN)
CASES = [
    ("em", "vp", dict(n_steps=13)),
    ("em", "ve", dict(n_steps=8)),
    ("pc", "vp", dict(n_steps=27)),
    ("pc", "ve", dict(n_steps=11, corrector_steps=2, snr=0.1)),
    ("pc_hmc", "vp", dict(n_steps=23)),
    ("pc_hmc", "ve", dict(n_steps=9, hmc_leapfrog=2)),
    ("ddim", "vp", dict(n_steps=19)),
    ("ode", "vp", dict(rtol=1e-3, atol=1e-3)),
    ("ode", "ve", dict(rtol=1e-3, atol=1e-3, max_iters=13)),
]
SDES = {"vp": tsde.VPSDE, "ve": lambda: tsde.VESDE(sigma_max=10.0)}


class StreamReplay:
    """``noise_fn`` that hands out a ``SlotStreams``' draws in the order a
    solve makes them: the k-th call is each row's draw at counter + k."""

    def __init__(self, streams):
        self.streams, self.k = streams, 0

    def __call__(self, x):
        z = self.streams.draw(x.shape[1:], self.k)
        self.k += 1
        return z


@pytest.fixture(autouse=True)
def _empty_cache():
    ad.clear_graph_cache()
    yield
    ad.clear_graph_cache()


def _inputs(sde, seed=3):
    st = seed_streams(seed, SHAPE[0], "cpu")
    return sde.prior_sample(SHAPE, st), st.advanced(1)


def _assert_same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _ids(cases):
    return [f"{m}-{s}-{'-'.join(map(str, k.values()))}" for m, s, k in cases]


@pytest.mark.parametrize("method,sde_name,kw", CASES, ids=_ids(CASES))
def test_driver_is_the_host_loop_on_the_same_draws(method, sde_name, kw):
    sde = SDES[sde_name]()
    score = tan.gaussian_score(sde, 0.3, 0.5)
    x0, st = _inputs(sde)
    solve = lambda **extra: get_solver(method)(sde, score, x0, st, device="cpu", **kw, **extra)
    first = solve()  # the key's first solve: host-driven
    assert not ad._drivers
    graphed = solve()  # the second: through the plain driver
    assert len(ad._drivers) == 1
    again = solve()
    assert len(ad._drivers) == 1
    host = get_solver(method)(sde, score, x0, st, device="cpu", noise_fn=StreamReplay(st),
                              **kw)
    for res in (first, graphed, again):
        _assert_same(res, host)
    assert torch.isfinite(host.x).all()


@pytest.mark.parametrize("method,kw", [
    ("em", [13, 21]), ("pc", [23, 30]), ("pc_hmc", [21, 26]), ("ddim", [9, 17]),
])
def test_one_driver_serves_two_grids(method, kw):
    """``n_steps`` is a per-solve value: a second grid replays the first
    grid's driver (on the CPU its plain loop) with its own buffers."""
    sde = tsde.VPSDE()
    score = tan.gaussian_score(sde, 0.3, 0.5)
    x0, st = _inputs(sde)
    for n in kw:
        for _ in range(2):
            got = get_solver(method)(sde, score, x0, st, device="cpu", n_steps=n)
        assert len(ad._drivers) == 1
        want = get_solver(method)(sde, score, x0, st, device="cpu", n_steps=n,
                                  noise_fn=StreamReplay(st))
        _assert_same(got, want)
        assert int(got.iterations) == n


def test_ode_tolerances_share_one_driver():
    sde = tsde.VPSDE()
    score = tan.gaussian_score(sde, 0.3, 0.5)
    x0, _ = _inputs(sde)
    run = lambda tol, **kw: get_solver("ode")(sde, score, x0, device="cpu", rtol=tol,
                                              atol=tol, **kw)
    run(1e-2)
    run(1e-2)
    loose = run(1e-2)
    tight = run(1e-3)
    assert len(ad._drivers) == 1 and int(tight.iterations) > int(loose.iterations)
    _assert_same(tight, run(1e-3, noise_fn=lambda x: x))  # the host-driven groups
    run(1e-3, max_iters=50)  # the attempt budget shapes the window: another key
    assert len(ad._seen) == 2


@pytest.mark.parametrize("method", ["em", "pc", "ddim", "ode", "adaptive"])
def test_one_shot_rule(method, monkeypatch):
    """A key's first solve runs the host-driven loop and records the key,
    the second builds the driver (the card's one capture), the third
    reuses it: 0, 1, 0 drivers built."""
    built = []
    real = ad.HorizonDriver.__init__

    def spy(self, *a, **k):
        built.append(1)
        real(self, *a, **k)

    monkeypatch.setattr(ad.HorizonDriver, "__init__", spy)
    sde = tsde.VPSDE()
    score = tan.gaussian_score(sde, 0.3, 0.5)
    kw = {"em": dict(n_steps=9), "pc": dict(n_steps=25), "ddim": dict(n_steps=9),
          "ode": dict(rtol=1e-3, atol=1e-3), "adaptive": dict(eps_rel=0.1)}[method]
    counts, results = [], []
    for _ in range(3):
        n = len(built)
        results.append(sample(sde, score, SHAPE, seed=1, method=method, device="cpu", **kw))
        counts.append(len(built) - n)
    assert counts == [0, 1, 0]
    for r in results[1:]:
        _assert_same(r, results[0])


def test_adaptive_tolerances_share_one_driver():
    """Algorithm 1's eps_rel and eps_abs become the carry's per-sample
    tolerance buffers: two tolerances, one driver, each solve bitwise
    its host-driven chain."""
    sde = tsde.VPSDE()
    score = tan.gaussian_score(sde, 0.3, 0.5)
    results = {}
    for eps in (0.1, 0.1, 0.02, 0.02):
        results[eps] = sample(sde, score, SHAPE, seed=2, device="cpu", eps_rel=eps,
                              eps_abs=eps / 10)
    assert len(ad._drivers) == 1
    for eps, res in results.items():
        st = seed_streams(2, SHAPE[0], "cpu")
        cfg = ad.AdaptiveConfig(eps_rel=eps, eps_abs=eps / 10)
        carry = ad.init_carry(sde, sde.prior_sample(SHAPE, st), st.advanced(1), config=cfg)
        carry = ad.solve_chunk(sde, score, carry, max_sync_iters=cfg.max_iters, config=cfg)
        want = ad.finalize(sde, score, carry)
        for f in FIELDS + ("accepted", "rejected"):
            assert torch.equal(getattr(res, f), getattr(want, f)), (eps, f)
    assert int(results[0.02].iterations) > int(results[0.1].iterations)


def test_grid_window_runs_one_step_a_horizon(monkeypatch):
    """The fixed grid's horizon is one step and its condition ``step <
    n_steps``: n_steps horizons, none past the grid (no score evaluation
    beyond the host loop's)."""
    calls, evals = [], []
    real = loop_ref.solve_horizons

    def spy(unit, carry, occupied, **kw):
        out = real(unit, carry, occupied, **kw)
        calls.append((tuple(occupied.shape), kw["max_horizons"], out[2]))
        return out

    monkeypatch.setattr(loop_ref, "solve_horizons", spy)
    sde = tsde.VPSDE()
    inner = tan.gaussian_score(sde, 0.3, 0.5)
    score = lambda x, t: evals.append(1) or inner(x, t)
    x0, st = _inputs(sde)
    for _ in range(2):
        get_solver("em")(sde, score, x0, st, device="cpu", n_steps=11, denoise=False)
    assert calls == [((1,), ad.UNBOUNDED, 11)]
    assert len(evals) == 2 * 11


@pytest.mark.parametrize("n_steps", [1, 2, 7, 13, 50, 1000])
@pytest.mark.parametrize("sde_name", ["vp", "ve"])
def test_step_times_are_the_grids(sde_name, n_steps):
    """The step's grid point from its counter is ``em_times``' and
    ``linspace_f32``'s point bit for bit (those two are held against the
    reference in ``test_torch_baselines.py``)."""
    sde = SDES[sde_name]()
    c = grid.init_grid(sde, torch.zeros(2, 3), n_steps)
    T, t_eps = grid.ends(sde)
    at = lambda i: dataclasses.replace(c, iterations=torch.tensor(i, dtype=torch.int32))
    em = torch.stack([grid.em_time(at(i), T) for i in range(n_steps)])
    lin = torch.stack([grid.linspace_point(c, torch.tensor(i, dtype=torch.int32), T, t_eps)
                       for i in range(n_steps + 1)])
    assert torch.equal(em, em_times(sde, n_steps))
    assert torch.equal(lin, linspace_f32(sde.T, sde.t_eps, n_steps + 1))


def test_noise_fn_and_generator_keep_the_host_loop():
    sde = tsde.VPSDE()
    score = tan.gaussian_score(sde, 0.3, 0.5)
    x0, st = _inputs(sde)
    for _ in range(3):
        get_solver("em")(sde, score, x0, torch.Generator().manual_seed(0), device="cpu",
                         n_steps=5)
        get_solver("em")(sde, score, x0, st, device="cpu", n_steps=5,
                         noise_fn=StreamReplay(st))
        get_solver("ddim")(sde, score, x0, device="cpu", n_steps=5, noise_fn=lambda x: x)
    assert not ad._drivers and not ad._seen


def test_pc_draw_offsets():
    """PC's corrector pass k draws at the row's counter + k, the predictor
    at + corrector_steps, and a step moves the counter on by
    corrector_steps + 1."""
    sde = tsde.VESDE(sigma_max=10.0)
    score = tan.gaussian_score(sde, 0.3, 0.5)
    x0, st = _inputs(sde)
    seen = []

    class Spy(StreamReplay):
        def __call__(self, x):
            seen.append(self.k)
            return super().__call__(x)

    got = get_solver("pc")(sde, score, x0, st, device="cpu", n_steps=4, corrector_steps=3)
    want = get_solver("pc")(sde, score, x0, st, device="cpu", n_steps=4, corrector_steps=3,
                            noise_fn=Spy(st))
    assert seen == list(range(16))
    _assert_same(got, want)


# ------------------------------------------------ against the reference

class IndexedDraws:
    """Patches ``jax.random.split`` and ``jax.random.normal`` so that a
    reference solver's key is a draw index: ``split(k) = (k + 1, k)`` and
    ``normal(k, ...)`` is ``Z[k]``, the port's stream draws."""

    def __init__(self, monkeypatch, draws):
        z = jnp.asarray(draws)
        monkeypatch.setattr(jax.random, "split", lambda k, num=2: (k + 1, k))
        monkeypatch.setattr(jax.random, "normal",
                            lambda k, shape, dtype=jnp.float32: z[k].astype(dtype))


@pytest.mark.parametrize("method,sde_name,kw", [
    ("em", "vp", dict(n_steps=40)), ("em", "ve", dict(n_steps=30)),
    ("pc", "vp", dict(n_steps=25)), ("pc", "ve", dict(n_steps=15, corrector_steps=2)),
], ids=["em-vp", "em-ve", "pc-vp", "pc-ve-2"])
def test_sample_on_streams_matches_the_reference_fed_those_draws(monkeypatch, method,
                                                                sde_name, kw):
    """``sample(method=)`` on its per-row streams (the second call: through
    the driver) against the reference solver fed the same draws in the
    same order, at ``test_torch_baselines.py``'s bounds (fp32 rtol 1e-5,
    atol 1e-5·max|x|)."""
    js = {"vp": jsde.VPSDE(), "ve": jsde.VESDE(sigma_max=10.0)}[sde_name]
    ts = SDES[sde_name]()
    tscore = tan.gaussian_score(ts)
    for _ in range(2):
        got = sample(ts, tscore, SHAPE, seed=9, method=method, device="cpu", **kw)
    assert len(ad._drivers) == 1
    st = seed_streams(9, SHAPE[0], "cpu")
    x0 = ts.prior_sample(SHAPE, st)
    per_step = 1 + kw.get("corrector_steps", 1) if method == "pc" else 1
    n_draws = kw["n_steps"] * per_step
    draws = np.stack([st.advanced(1).draw(SHAPE[1:], k).numpy() for k in range(n_draws)])
    IndexedDraws(monkeypatch, draws)
    fn = {"em": reference_em, "pc": reference_pc}[method]
    want = fn(js, jan.gaussian_score(js), jnp.asarray(x0.numpy()),
              jnp.asarray(0, jnp.int32), **kw)
    np.testing.assert_array_equal(got.nfe.numpy(), np.asarray(want.nfe))
    assert int(got.iterations) == int(want.iterations)
    want_x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want_x).max())))
