"""Port ↔ reference parity: Algorithm 1 (``repro_torch.core.solvers.adaptive``).

JAX's threefry and torch's generators never give the same numbers, so
the port's solver is handed the reference's own noise through its
``noise_fn`` seam: ``ReferenceNoise`` replays the key threading of the
reference's ``_draw_noise`` (one ``split`` per iteration, the draw from
the second key). With equal noise the two solvers must take the same
decisions: per-sample ``nfe``, ``accepted`` and ``rejected`` exactly
equal, ``iterations`` equal, and x allclose with rtol 1e-4: the step math
is the same fp32 arithmetic with reductions in another order, compounded
over the trajectory. The absolute part of the bound is 1e-5 of the
largest |x| (at least 1e-5): an element that ends near zero is a sum of
terms as large as the sample, and its rounding error scales with them,
not with the element (the livened DiT's samples reach |x| ≈ 240).
"""

import dataclasses
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
from repro_torch.core.sampling import sample, solve_in_chunks
from repro_torch.core.solvers import adaptive as tad
from repro_torch.core.solvers import get_solver, solver_nfe_per_iteration
from repro_torch.models import dit as tdit

from test_torch_dit import JCFG, TCFG, reference_params

# the package re-exports the function ``adaptive`` under the module's name
jad = importlib.import_module("repro.core.solvers.adaptive")

torch.set_num_threads(2)

SDES = {"vp": (jsde.VPSDE(), tsde.VPSDE()),
        "ve": (jsde.VESDE(sigma_max=10.0), tsde.VESDE(sigma_max=10.0))}


@jax.jit
def _split_normal_like(key, x):
    key, sub = jax.random.split(key)
    return key, jax.random.normal(sub, x.shape, jnp.float32)


class ReferenceNoise:
    """``noise_fn`` that replays the reference's shared-key noise stream."""

    def __init__(self, key):
        self.key = key

    def __call__(self, x):
        self.key, z = _split_normal_like(self.key, jnp.zeros(x.shape, jnp.float32))
        return torch.from_numpy(np.array(z))


def _prior(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_same_solve(got, want):
    for name in ("nfe", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.iterations) == int(want.iterations)
    want_x = np.asarray(want.x)
    atol = 1e-5 * max(1.0, float(np.abs(want_x).max()))
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("name", sorted(SDES))
def test_whole_solve_analytic_score(name, fused):
    js, ts = SDES[name]
    x0 = _prior((16, 4, 4, 1))
    key = jax.random.PRNGKey(3)
    want = jad.adaptive(js, jan.gaussian_score(js), jnp.asarray(x0), key,
                        eps_rel=0.02)
    got = tad.adaptive(ts, tan.gaussian_score(ts), torch.from_numpy(x0),
                       noise_fn=ReferenceNoise(key), device="cpu", eps_rel=0.02,
                       use_fused_kernel=fused)
    assert int(got.rejected.sum()) > 0 and int(got.accepted.sum()) > 0
    _assert_same_solve(got, want)


def test_whole_solve_livened_dit():
    """The small livened DiT as the score network, through the port's
    flash wrapper and fused step (their plain versions on the CPU)."""
    tree = reference_params()
    js, ts = SDES["vp"]
    jscore = jdit.make_score_fn(jax.tree_util.tree_map(jnp.asarray, tree), JCFG, js)
    model = tdit.params_from_jax(tree, dataclasses.replace(TCFG, use_flash=True))
    tscore = tdit.make_score_fn(model, ts)
    x0 = _prior((3, 16, 16, 3), seed=1)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda x, k: jad.adaptive(js, jscore, x, k, eps_rel=0.05))(
        jnp.asarray(x0), key)
    got = tad.adaptive(ts, tscore, torch.from_numpy(x0), noise_fn=ReferenceNoise(key),
                       device="cpu", eps_rel=0.05, use_fused_kernel=True)
    _assert_same_solve(got, want)


def test_per_sample_tolerances():
    js, ts = SDES["vp"]
    x0 = _prior((6, 8))
    atol = np.array([0.002, 0.004, 0.0078, 0.01, 0.02, 0.05], np.float32)
    rtol = np.array([0.5, 0.2, 0.05, 0.05, 0.01, 0.02], np.float32)
    key = jax.random.PRNGKey(7)
    want = jad.adaptive(js, jan.gaussian_score(js), jnp.asarray(x0), key,
                        atol=jnp.asarray(atol), rtol=jnp.asarray(rtol))
    for fused in (False, True):
        got = tad.adaptive(ts, tan.gaussian_score(ts), torch.from_numpy(x0),
                           noise_fn=ReferenceNoise(key), device="cpu",
                           atol=torch.from_numpy(atol), rtol=torch.from_numpy(rtol),
                           use_fused_kernel=fused)
        _assert_same_solve(got, want)
    assert len(set(got.nfe.tolist())) > 1  # the tiers really differ
    with pytest.raises(ValueError):
        tad.init_carry(ts, torch.zeros(2, 3), None, atol=0.1)


def _to_port(c):
    return tad.SolverCarry(
        x=torch.from_numpy(np.array(c.x)), x_prev=torch.from_numpy(np.array(c.x_prev)),
        t=torch.from_numpy(np.array(c.t)), h=torch.from_numpy(np.array(c.h)),
        nfe=torch.from_numpy(np.array(c.nfe)),
        accepted=torch.from_numpy(np.array(c.accepted)),
        rejected=torch.from_numpy(np.array(c.rejected)),
        done=torch.from_numpy(np.array(c.done)),
        iterations=torch.from_numpy(np.array(c.iterations)))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_one_body_step_from_identical_carries(fused):
    """Along the reference's trajectory, one port iteration from the same
    carry with the same z takes the same accept decision per sample."""
    js, ts = SDES["vp"]
    jscore, tscore = jan.gaussian_score(js), tan.gaussian_score(ts)
    jcfg = jad.AdaptiveConfig(eps_rel=0.02)
    tcfg = tad.AdaptiveConfig(eps_rel=0.02, use_fused_kernel=fused)
    step = jax.jit(lambda c: jad.solve_chunk(js, jscore, c, max_sync_iters=1,
                                             config=jcfg))
    carry = jad.init_carry(js, jnp.asarray(_prior((16, 24))), jax.random.PRNGKey(9),
                           config=jcfg)
    body = None
    compared = 0
    while not bool(carry.done.all()):
        nxt = step(carry)
        body = tad._make_body(ts, tscore, tcfg, ts.abs_tolerance,
                              tad._step_math_fused if fused else tad._step_math_jnp,
                              ReferenceNoise(carry.key))
        got = body(_to_port(carry))
        for name in ("accepted", "rejected", "nfe", "done"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(nxt, name)), err_msg=name)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(nxt.x), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.h.numpy(), np.asarray(nxt.h), rtol=1e-5, atol=1e-7)
        carry, compared = nxt, compared + 1
    assert int(carry.rejected.sum()) > 0 and compared > 20


@pytest.mark.parametrize("horizon", [1, 4, 16])
def test_chunked_is_monolithic_bitwise(horizon):
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts)
    kw = dict(seed=11, device="cpu", eps_rel=0.02)
    mono = sample(ts, score, (8, 12), **kw)
    seen = []
    chunked = solve_in_chunks(ts, score, (8, 12), max_sync_iters=horizon,
                              on_sync=lambda c: seen.append(int(c.iterations)), **kw)
    assert torch.equal(chunked.x, mono.x)
    for name in ("nfe", "accepted", "rejected", "iterations"):
        assert torch.equal(getattr(chunked, name), getattr(mono, name)), name
    assert seen == sorted(seen) and len(seen) == -(-int(mono.iterations) // horizon)


def test_max_iters_cap():
    js, ts = SDES["vp"]
    x0 = _prior((5, 6))
    key = jax.random.PRNGKey(13)
    for cap in (3, 13):
        want = jad.adaptive(js, jan.gaussian_score(js), jnp.asarray(x0), key,
                            max_iters=cap, denoise=False)
        got = tad.adaptive(ts, tan.gaussian_score(ts), torch.from_numpy(x0),
                           noise_fn=ReferenceNoise(key), device="cpu",
                           max_iters=cap, denoise=False)
        assert int(got.iterations) == cap
        _assert_same_solve(got, want)


def test_registry():
    assert get_solver("adaptive") is tad.adaptive
    assert solver_nfe_per_iteration("adaptive") == 2
    with pytest.raises(ValueError):
        get_solver("not_a_solver")
    ts = tsde.VPSDE()
    r = sample(ts, tan.gaussian_score(ts), (4, 3), device="cpu", eps_rel=0.05)
    assert torch.equal(r.nfe, 2 * (r.accepted + r.rejected) + 1)
