"""The solver zoo's registry contract as properties: the mirror of the zoo
rows of ``tests/test_property_hypothesis.py`` (the shared ``sample(...)``
signature, finite samples, the NFE accounting by family, and the carry
family integrating to exactly t_eps), on the port's own solves on the
CPU over hypothesis's seeds.
"""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import analytic as tan
from repro_torch.core.sampling import sample, seed_streams
from repro_torch.core.sde import VPSDE
from repro_torch.core.solvers import available_solvers
from repro_torch.core.solvers.adaptive import AdaptiveConfig, finalize, init_carry, solve_chunk

torch.set_num_threads(2)

SHAPE = (4, 6)
#: the reference's cheap per-solver kwargs: the property under test is
#: the registry contract, not sample accuracy (the pc family needs ≥ 32
#: grid steps, as there)
FAST_KWARGS = {
    "adaptive": dict(eps_rel=0.3),
    "momentum": dict(eps_rel=0.3),
    "heun": dict(eps_rel=0.3),
    "em": dict(n_steps=8),
    "ddim": dict(n_steps=8),
    "pc": dict(n_steps=32),
    "pc_hmc": dict(n_steps=32),
    "ode": {},
}
CARRY_FAMILY = ("adaptive", "momentum", "heun")

SDE = VPSDE()
SCORE = tan.gaussian_score(SDE, 0.3, 0.5)
PROPERTY = settings(max_examples=30, deadline=None)


def _solve(method, denoise, seed):
    return sample(SDE, SCORE, SHAPE, seed=seed, method=method, denoise=denoise,
                  device="cpu", **FAST_KWARGS[method])


def test_fast_kwargs_cover_registry():
    """A solver registered without a FAST_KWARGS row escapes the
    properties below."""
    assert set(available_solvers()) == set(FAST_KWARGS)


@PROPERTY
@given(st.sampled_from(sorted(FAST_KWARGS)), st.booleans(), st.integers(0, 2 ** 16))
def test_registry_shared_signature_and_finite_samples(method, denoise, seed):
    """Every registered solver accepts the one ``sample(...)`` signature
    and returns finite samples of the requested shape, for any seed."""
    res = _solve(method, denoise, seed)
    assert res.x.shape == SHAPE
    assert bool(torch.isfinite(res.x).all())
    assert res.nfe.shape == (SHAPE[0],)
    assert bool((res.nfe > 0).all())


@PROPERTY
@given(st.sampled_from(sorted(FAST_KWARGS)), st.booleans(), st.integers(0, 2 ** 16))
def test_registry_nfe_accounting(method, denoise, seed):
    """The carry family obeys nfe == 2·(accepted + rejected) (+1 for the
    denoise); fixed-grid solvers report their exact grid cost with zero
    accept/reject counters; the batch-global RK45 one uniform count."""
    res = _solve(method, denoise, seed)
    nfe, acc, rej = (getattr(res, f).numpy() for f in ("nfe", "accepted", "rejected"))
    extra = 1 if denoise else 0
    if method in CARRY_FAMILY:
        np.testing.assert_array_equal(nfe, 2 * (acc + rej) + extra)
        assert (acc > 0).all()
    else:
        assert (acc == 0).all() and (rej == 0).all()
        n_steps = FAST_KWARGS[method].get("n_steps")
        per_step = {"em": 1, "ddim": 1, "pc": 2, "pc_hmc": 4}.get(method)
        if per_step is not None:  # pc: predictor + Langevin; pc_hmc: + L=3 leapfrog
            np.testing.assert_array_equal(nfe, per_step * n_steps + extra)
        else:
            assert (nfe == nfe[0]).all()


@PROPERTY
@given(st.sampled_from(CARRY_FAMILY), st.integers(0, 2 ** 16))
def test_carry_family_respects_t_eps(method, seed):
    """The carry family integrates to exactly t_eps, never below, for every
    config variant of the Algorithm-1 body."""
    cfg = {"adaptive": AdaptiveConfig(eps_rel=0.3),
           "momentum": AdaptiveConfig(eps_rel=0.3, momentum=0.15),
           "heun": AdaptiveConfig(eps_rel=0.3, probability_flow=True)}[method]
    streams = seed_streams(seed, SHAPE[0], "cpu")
    carry = init_carry(SDE, SDE.prior_sample(SHAPE, streams), streams.advanced(1), config=cfg)
    carry = solve_chunk(SDE, SCORE, carry, max_sync_iters=cfg.max_iters, config=cfg)
    assert bool(carry.done.all())
    t = carry.t.numpy()
    assert (t <= SDE.t_eps + 1e-12).all()
    assert (t >= SDE.t_eps - 1e-6).all()
    res = finalize(SDE, SCORE, carry, denoise=False)
    assert bool(torch.isfinite(res.x).all())
