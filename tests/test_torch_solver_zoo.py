"""Port ↔ reference parity: the solver zoo (``core/solvers/momentum.py``,
``core/solvers/heun.py``), its auto-selection (``analysis/solver_select``)
and the last conditioners (``Colorize``, ``gray_basis``, ``to_gray``, the
functional ``classifier_free``).

Noise is the reference's own, replayed through ``noise_fn``
(``ReferenceNoise``), since JAX's threefry and torch's generators never
agree. Two bounds, stated here:

  * **one iteration at a time**: from every carry of the reference's whole
    trajectory, one port iteration against one reference iteration; the
    accept bits exactly equal, x, x_prev and h within rtol 1e-5 and an
    absolute 1e-6 of the largest |x| (the same fp32 arithmetic, a few
    ulps apart: XLA rounds the score and the coefficients differently);
  * **whole solves**: per-sample nfe, accepted and rejected and the
    iterations exactly equal; x within an absolute 1e-5 of the largest
    |x|, except three cases with their own bound (``WHOLE_ATOL``), each
    about three times the larger of two readings: the port's gap and the
    reference's own spread when its prior moves by one ulp
    (``python tests/test_torch_solver_zoo.py`` prints both). The step
    size follows an error estimate that cancels (x'' − x'), so one ulp
    moves h by up to 1e-5 relative, and over 40–150 iterations that
    compounds: on VP Heun and on VE momentum the reference drifts from
    itself as far as from the port. The first bound holds every step.

Then the zoo's invariants on the port's own RNG: chunked ≡ monolithic
bitwise, nfe = 2·(accepted + rejected) + 1, Heun's stream counter, the
W2 gates of ``ZOO``, a family served with seatmates bitwise its solo run,
and the selection report.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import solver_select as jsel
from repro.core import analytic as jan
from repro.core import guidance as jgd
from repro.core import sde as jsde
from repro_torch.analysis import solver_select as tsel
from repro_torch.core import analytic as tan
from repro_torch.core import guidance as tgd
from repro_torch.core import sde as tsde
from repro_torch.core.sde import bcast
from repro_torch.core.sampling import sample, solve_in_chunks
from repro_torch.core.solvers import adaptive as tad
from repro_torch.core.solvers import get_solver, solver_nfe_per_iteration
from repro_torch.core.solvers.base import SlotStreams
from repro_torch.core.solvers.heun import heun_config
from repro_torch.core.solvers.momentum import DEFAULT_BETA, momentum_config
from repro_torch.launch.sample import make_sample_step
from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

from test_torch_adaptive import ReferenceNoise

jad = importlib.import_module("repro.core.solvers.adaptive")
jmom = importlib.import_module("repro.core.solvers.momentum")

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
SDES = {"vp": (jsde.VPSDE(), tsde.VPSDE()),
        "ve": (jsde.VESDE(sigma_max=10.0), tsde.VESDE(sigma_max=10.0)),
        "subvp": (jsde.SubVPSDE(), tsde.SubVPSDE())}
#: the zoo's two families as config fields, in both packages
FAMILY = {"momentum": dict(momentum=jmom.DEFAULT_BETA), "heun": dict(probability_flow=True)}
KW = dict(eps_rel=0.05)  # ZOO's tolerance of both families
SHAPE = (16, 4, 4, 1)
STEP_RTOL = 1e-5
#: whole-solve bound on |x - reference| over the largest |x|: 1e-5, or the
#: case's own (readings: the port's gap, the reference's spread over 12
#: one-ulp moves of its prior; printed by running this file)
WHOLE_ATOL = {("heun", "vp"): 2e-4, ("momentum", "vp"): 2e-5, ("momentum", "ve"): 3e-3}
CASES = [(f, n, fused) for f in sorted(FAMILY) for n in sorted(SDES) for fused in (False, True)]
IDS = [f"{f}-{n}-{'fused' if fu else 'plain'}" for f, n, fu in CASES]


def _prior(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _to_port(c):
    return tad.SolverCarry(**{f: torch.from_numpy(np.array(getattr(c, f))) for f in (
        "x", "x_prev", "t", "h", "nfe", "accepted", "rejected", "done", "iterations")})


def _close(got: torch.Tensor, want, rtol, atol_of_max) -> None:
    want = np.asarray(want)
    atol = atol_of_max * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("family,name,fused", CASES, ids=IDS)
def test_family_matches_reference_step_by_step(family, name, fused):
    """Every iteration of the reference's whole solve, stepped from its own
    carry: the accept bits exactly, x, x_prev and h at rtol 1e-5."""
    js, ts = SDES[name]
    jcfg = jad.AdaptiveConfig(**KW, **FAMILY[family])
    tcfg = tad.AdaptiveConfig(**KW, **FAMILY[family], use_fused_kernel=fused)
    jstep = jax.jit(lambda c: jad.solve_chunk(js, jan.gaussian_score(js), c,
                                              max_sync_iters=1, config=jcfg))
    jc = jad.init_carry(js, jnp.asarray(_prior()), jax.random.PRNGKey(3), config=jcfg)
    steps = 0
    while not bool(np.asarray(jc.done).all()):
        got = tad.solve_chunk(ts, tan.gaussian_score(ts), _to_port(jc), max_sync_iters=1,
                              config=tcfg, noise_fn=ReferenceNoise(jc.key))
        jc = jstep(jc)
        for f in ("accepted", "rejected", "nfe", "done"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jc, f)),
                                          err_msg=f"{f} at iteration {steps}")
        for f in ("x", "x_prev", "h"):
            _close(getattr(got, f), getattr(jc, f), STEP_RTOL, 1e-6)
        steps += 1
    assert steps > 20 and int(jc.rejected.sum()) > 0


def _whole_solves(family, name, fused, x0):
    """(port, reference) whole solves of ``family`` on ``name`` from ``x0``
    on the reference's noise."""
    js, ts = SDES[name]
    key = jax.random.PRNGKey(3)
    want = getattr(importlib.import_module(f"repro.core.solvers.{family}"), family)(
        js, jan.gaussian_score(js), jnp.asarray(x0), key, **KW)
    got = get_solver(family)(ts, tan.gaussian_score(ts), torch.from_numpy(x0),
                             noise_fn=ReferenceNoise(key), device="cpu",
                             use_fused_kernel=fused, **KW)
    return got, want


@pytest.mark.parametrize("family,name,fused", CASES, ids=IDS)
def test_family_whole_solve_matches_reference(family, name, fused):
    got, want = _whole_solves(family, name, fused, _prior())
    for f in ("nfe", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.iterations) == int(want.iterations)
    _close(got.x, want.x, 0.0, WHOLE_ATOL.get((family, name), 1e-5))


def test_family_configs_follow_the_reference():
    assert DEFAULT_BETA == jmom.DEFAULT_BETA
    assert momentum_config().momentum == DEFAULT_BETA
    assert momentum_config(momentum=0.3).momentum == 0.3
    assert heun_config(eps_rel=0.2).probability_flow
    assert {f.name for f in dataclasses.fields(tad.AdaptiveConfig)} == {
        f.name for f in dataclasses.fields(jad.AdaptiveConfig)}


# ------------------------------------------------ invariants, the port's RNG


@pytest.mark.parametrize("family", sorted(FAMILY) + ["adaptive"])
@pytest.mark.parametrize("horizon", [1, 7, 64])
def test_chained_chunks_bitwise_match_monolithic(horizon, family):
    """Mirror of ``tests/test_solver_chunking.py``: chained chunks are
    the monolithic solve bit for bit, for every carry family."""
    ts = tsde.VPSDE()
    cfg = tad.AdaptiveConfig(**KW, **FAMILY.get(family, {}))
    mono = sample(ts, tan.gaussian_score(ts, MU, S0), (8, 16), seed=4, config=cfg,
                  device="cpu")
    chunked = solve_in_chunks(ts, tan.gaussian_score(ts, MU, S0), (8, 16), seed=4,
                              max_sync_iters=horizon, config=cfg, device="cpu")
    for f in ("x", "nfe", "accepted", "rejected", "iterations"):
        assert torch.equal(getattr(mono, f), getattr(chunked, f)), f


@pytest.mark.parametrize("family", sorted(FAMILY))
def test_nfe_rule_with_denoise(family):
    """nfe = 2·(accepted + rejected) + 1 (the Tweedie evaluation)."""
    ts = tsde.VPSDE()
    res = sample(ts, tan.gaussian_score(ts, MU, S0), (16, 8), seed=0, method=family,
                 device="cpu", **KW)
    assert solver_nfe_per_iteration(family) == 2
    assert torch.equal(res.nfe, 2 * (res.accepted + res.rejected) + 1)
    assert int(res.rejected.sum()) > 0


def _streams_solve(cfg, cond=None, batch=4, dim=16):
    ts = tsde.VPSDE()
    streams = SlotStreams.of(list(range(batch)), 1, device="cpu")
    x0 = ts.prior_sample((batch, dim), SlotStreams.of(list(range(batch)), 0, device="cpu"))
    carry = tad.init_carry(ts, x0, streams, config=cfg, cond=cond)
    return tad.solve_chunk(ts, tan.gaussian_score(ts, MU, S0), carry, max_sync_iters=10_000,
                           config=cfg)


def test_heun_stream_counter():
    """Heun draws no z: a stream's counter does not move without a
    projecting conditioner, and moves once an iteration with one; the SDE
    solver's moves once (twice with the projection)."""
    mask = torch.zeros(4, 16)
    mask[:, :4] = 1.0
    conditioner, cond = tgd.inpaint(mask, torch.full((4, 16), 0.2))
    for family, draws in (("heun", 0), ("adaptive", 1)):
        for proj in (False, True):
            cfg = tad.AdaptiveConfig(**KW, **FAMILY.get(family, {}),
                                     conditioner=conditioner if proj else None)
            out = _streams_solve(cfg, cond if proj else None)
            iters = int(out.iterations)
            want = 1 + (draws + int(proj)) * iters
            assert out.generator.counter.tolist() == [want] * 4, (family, proj)
    # without noise the streams play no part: a shared generator gives the same bits
    ts = tsde.VPSDE()
    x0 = ts.prior_sample((4, 16), SlotStreams.of(list(range(4)), 0, device="cpu"))
    alone = get_solver("heun")(ts, tan.gaussian_score(ts, MU, S0), x0,
                               torch.Generator().manual_seed(9), device="cpu",
                               denoise=False, **KW)
    assert torch.equal(alone.x, _streams_solve(heun_config(**KW)).x)


@pytest.mark.parametrize("family", sorted(FAMILY))
@pytest.mark.parametrize("name", ["vp", "ve"])
def test_family_meets_its_w2_gate(family, name):
    """The conformance row of ``ZOO`` on the port's own RNG: W2 to the
    closed-form OU marginal below the family's gate."""
    _, ts = SDES[name]
    row = tsel.conformance_row(family, name, ts, device="cpu")
    assert row["tol"] == tsel.ZOO[family]["tol"]
    assert row["w2"] < row["tol"], row


def test_zoo_and_selection_report_follow_the_reference(tmp_path):
    assert tsel.ZOO == jsel.ZOO
    assert tsel.zoo_cases() == jsel.zoo_cases()
    rng = np.random.default_rng(0)
    rows = [{"solver": s, "sde": w, "w2": float(rng.uniform(0.0, 0.3)),
             "mean_nfe": float(rng.integers(20, 400)), "tol": tsel.ZOO[s]["tol"]}
            for w in ("vp", "ve", "vp:traj16x6") for s in tsel.ZOO]
    rows += [dict(rows[0], precision="bf16"), dict(rows[1], conditioner="inpaint"),
             dict(rows[2], solver="not_in_the_zoo")]
    report = tsel.select(rows)
    assert report == jsel.select(rows)
    assert tsel.render_markdown(report) == jsel.render_markdown(report)
    md, js = tsel.write_selection(report, str(tmp_path / "sel"))
    assert open(md).read() == jsel.render_markdown(report)
    assert open(js).read() == open(jsel.write_selection(report, str(tmp_path / "ref"))[1]).read()


@pytest.mark.parametrize("family", sorted(FAMILY))
@pytest.mark.parametrize("resident", [False, True], ids=["host", "device"])
def test_family_served_bitwise_its_solo_run(family, resident):
    """A family's server (``solver=``) keeps exact books, and each request
    served with seatmates is bitwise its batch-1 solve on its own stream:
    momentum's v starts at 0 at admission (x_prev = the prior) and moves
    with its row through compaction."""
    ts = tsde.VPSDE()
    cfg = tad.AdaptiveConfig(**KW, **FAMILY[family], use_fused_kernel=True)
    fwd = tan.gaussian_noise_pred(ts, MU, S0)
    step = make_sample_step(ts, cfg, forward_fn=lambda p, x, t: fwd(x, t))
    srv = DiffusionBatcher(ts, step, None, (16,), slots=3, cfg=cfg, sync_horizon=2,
                           device="cpu", solver=family, device_resident=resident)
    assert srv.nfe_per_iter == 2
    for uid in range(7):
        srv.submit(ImageRequest(uid=uid, seed=100 + uid))
    done = srv.run_to_completion()
    assert len(done) == 7

    def score(x, t):  # make_sample_step's wrapping of the noise prediction
        return -fwd(x, t) / bcast(ts.marginal(t)[1], x)

    for uid, req in done.items():
        streams = SlotStreams.of([req.seed], 1, device="cpu")
        x0 = ts.prior_sample((1, 16), SlotStreams.of([req.seed], 0, device="cpu"))
        solo = tad.adaptive(ts, score, x0, streams, config=cfg, denoise=False, device="cpu")
        assert np.array_equal(solo.x[0].numpy(), req.result), uid
        assert int(solo.nfe[0]) == req.nfe == 2 * (req.accepted + req.rejected)
    assert 0.0 <= srv.wasted_nfe_fraction < 1.0


# ------------------------------------------------------------ conditioners


def test_gray_basis_is_orthonormal_and_the_reference_bits():
    for c in (1, 3, 4):
        m = tgd.gray_basis(c)
        assert m.dtype == torch.float32
        np.testing.assert_array_equal(m.numpy(), np.asarray(jgd.gray_basis(c)))
        np.testing.assert_allclose((m @ m.T).numpy(), np.eye(c), atol=1e-6)
        np.testing.assert_allclose(m[0].numpy(), np.full(c, 1 / np.sqrt(c)), atol=1e-6)


def test_colorize_hooks_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 4, 4, 3)).astype(np.float32)
    z = rng.standard_normal((5, 4, 4, 3)).astype(np.float32)
    t = rng.uniform(0.01, 1.0, 5).astype(np.float32)
    gray = np.array(jgd.to_gray(jnp.asarray(x)))
    np.testing.assert_allclose(tgd.to_gray(torch.from_numpy(x)).numpy(), gray,
                               rtol=1e-6, atol=1e-6)
    jc, jcond = jgd.colorize(gray[..., 0])
    tc, tcond = tgd.colorize(torch.from_numpy(gray[..., 0]))
    assert tcond["gray"].shape == (5, 4, 4, 1) and tc == tgd.Colorize(channels=3)
    assert tc.cond_struct(5, (4, 4, 3))["gray"].shape == (5, 4, 4, 1)
    assert tgd.colorize(None) == (None, None)
    want = jc.project(jsde.VPSDE(), jnp.asarray(x), jnp.asarray(t), jcond, jnp.asarray(z))
    got = tc.project(tsde.VPSDE(), torch.from_numpy(x), torch.from_numpy(t), tcond,
                     torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    want = jc.finalize_project(jnp.asarray(z), jcond)
    got = tc.finalize_project(torch.from_numpy(z), tcond)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_colorize_pins_gray_component():
    """Mirror of ``tests/test_guidance.py``: the delivered samples' gray
    component is the payload's."""
    ts = tsde.VPSDE()
    shape = (16, 4, 4, 3)
    ref = MU + S0 * torch.randn(shape, generator=torch.Generator().manual_seed(3))
    gray = tgd.to_gray(ref)
    conditioner, cond = tgd.colorize(gray)
    res = sample(ts, tan.gaussian_score(ts, MU, S0), shape, seed=0, eps_rel=0.05,
                 conditioner=conditioner, cond=cond, device="cpu")
    np.testing.assert_allclose(tgd.to_gray(res.x).numpy(), gray.numpy(), atol=1e-5)
    assert bool(torch.isfinite(res.x).all())


def test_functional_classifier_free_matches_the_reference():
    js, ts = SDES["vp"]
    x = _prior((6, 8), seed=2)
    t = np.linspace(0.05, 1.0, 6).astype(np.float32)
    jf = jgd.classifier_free(jan.gaussian_score(js, 1.0, S0), jan.gaussian_score(js, MU, S0),
                             1.5)
    tf = tgd.classifier_free(tan.gaussian_score(ts, 1.0, S0), tan.gaussian_score(ts, MU, S0),
                             1.5)
    np.testing.assert_allclose(tf(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
                               np.asarray(jf(jnp.asarray(x), jnp.asarray(t))),
                               rtol=1e-5, atol=1e-6)
    uncond = tan.gaussian_score(ts, MU, S0)
    assert tgd.classifier_free(tan.gaussian_score(ts), uncond, 0.0) is uncond


def _drift_readings(moves: int = 12) -> None:
    """Prints, for each whole-solve case, the port's gap to the reference
    and the reference's own spread (median, max) over ``moves`` solves from
    its prior with each element moved by one ulp at random, both over the
    largest |x|, with the bound the test holds."""
    rng = np.random.default_rng(123)
    x0 = _prior()
    for family, name, fused in CASES:
        got, want = _whole_solves(family, name, fused, x0)
        w = np.asarray(want.x)
        top = max(1.0, float(np.abs(w).max()))
        gap = np.abs(got.x.numpy() - w).max() / top
        line = f"{family:8s} {name:5s} {'fused' if fused else 'plain'}: port {gap:.2e}"
        if fused:
            spread = []
            for _ in range(moves):
                away = rng.choice([-np.inf, np.inf], size=x0.shape).astype(np.float32)
                moved = np.where(rng.random(x0.shape) < 0.5, np.nextafter(x0, away), x0)
                spread.append(np.abs(np.asarray(_whole_solves(family, name, fused, moved)[1].x)
                                     - w).max() / top)
            line += (f", reference moved one ulp: median {np.median(spread):.2e} "
                     f"max {max(spread):.2e}")
        print(f"{line}; bound {WHOLE_ATOL.get((family, name), 1e-5):.0e}", flush=True)


if __name__ == "__main__":
    _drift_readings()
