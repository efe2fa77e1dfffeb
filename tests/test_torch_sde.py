"""Port ↔ reference parity: SDEs, tolerance math, precision presets and the
closed-form oracles (``repro_torch.core`` against ``repro.core``).

Inputs are made with numpy from a seed and fed to both packages. Bound:
rtol 1e-6 on fp32 control math — both sides run the same fp32 operations
in the same order, so only the last bit of a transcendental may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as jan
from repro.core import sde as jsde
from repro.core import tolerance as jtol
from repro.core.precision import PrecisionPolicy as JPolicy
from repro_torch.core import analytic as tan
from repro_torch.core import sde as tsde
from repro_torch.core import tolerance as ttol
from repro_torch.core.precision import PRESETS, PrecisionPolicy

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-7)

SDES = {
    "ve": (jsde.VESDE(), tsde.VESDE()),
    "ve10": (jsde.VESDE(sigma_max=10.0), tsde.VESDE(sigma_max=10.0)),
    "vp": (jsde.VPSDE(), tsde.VPSDE()),
    "subvp": (jsde.SubVPSDE(), tsde.SubVPSDE()),
}


def _grid():
    rng = np.random.default_rng(0)
    return np.concatenate([np.linspace(1e-5, 1.0, 33),
                           rng.uniform(0, 1, 31)]).astype(np.float32)


def _np(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("name", sorted(SDES))
def test_coefficients_and_marginal(name):
    js, ts = SDES[name]
    t = _grid()
    tt = torch.from_numpy(t)
    np.testing.assert_allclose(_np(ts.drift_coeff(tt)), _np(js.drift_coeff(t)), **TOL)
    np.testing.assert_allclose(_np(ts.diffusion(tt)), _np(js.diffusion(t)), **TOL)
    (jm, js_), (tm, ts_) = js.marginal(t), ts.marginal(tt)
    np.testing.assert_allclose(_np(tm), _np(jm), **TOL)
    np.testing.assert_allclose(_np(ts_), _np(js_), **TOL)
    assert ts.abs_tolerance == js.abs_tolerance
    assert ts.prior_std() == js.prior_std()
    assert (ts.T, ts.t_eps) == (js.T, js.t_eps)


@pytest.mark.parametrize("name", sorted(SDES))
def test_tweedie_denoise(name):
    js, ts = SDES[name]
    rng = np.random.default_rng(1)
    x, s = (rng.standard_normal((4, 6, 6, 3)).astype(np.float32) for _ in range(2))
    want = js.tweedie_denoise(jnp.asarray(x), jnp.asarray(s))
    got = ts.tweedie_denoise(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_get_sde_and_prior_sample():
    assert tsde.get_sde("vp") == tsde.VPSDE()
    assert isinstance(tsde.get_sde("sub-vp"), tsde.SubVPSDE)
    with pytest.raises(ValueError):
        tsde.get_sde("nope")
    g = torch.Generator().manual_seed(0)
    x = tsde.VESDE(sigma_max=10.0).prior_sample((4096,), g)
    assert x.dtype == torch.float32 and abs(float(x.std()) - 10.0) < 0.5


@pytest.mark.parametrize("prev", [True, False], ids=["prev", "noprev"])
@pytest.mark.parametrize("vector_eps", [False, True], ids=["scalar", "vector"])
def test_tolerance_math(prev, vector_eps):
    rng = np.random.default_rng(2)
    xl, xh, xp = (rng.standard_normal((5, 7, 3)).astype(np.float32) for _ in range(3))
    if vector_eps:
        ea = rng.uniform(1e-3, 0.1, (5, 1, 1)).astype(np.float32)
        er = rng.uniform(0.01, 0.5, (5, 1, 1)).astype(np.float32)
        jea, jer, tea, ter = (jnp.asarray(ea), jnp.asarray(er),
                              torch.from_numpy(ea), torch.from_numpy(er))
    else:
        jea = tea = 0.0078
        jer = ter = 0.05
    jd = jtol.mixed_tolerance(jnp.asarray(xl), jnp.asarray(xp) if prev else None, jea, jer)
    td = ttol.mixed_tolerance(torch.from_numpy(xl),
                              torch.from_numpy(xp) if prev else None, tea, ter)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    for jf, tf in ((jtol.scaled_error_l2, ttol.scaled_error_l2),
                   (jtol.scaled_error_linf, ttol.scaled_error_linf)):
        want = jf(jnp.asarray(xl), jnp.asarray(xh), jd)
        got = tf(torch.from_numpy(xl), torch.from_numpy(xh), td)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_next_step_size():
    rng = np.random.default_rng(3)
    h = rng.uniform(1e-4, 0.1, 64).astype(np.float32)
    err = np.concatenate([[0.0, 1e-12], rng.uniform(0, 5, 62)]).astype(np.float32)
    rem = rng.uniform(0, 0.05, 64).astype(np.float32)
    want = jtol.next_step_size(jnp.asarray(h), jnp.asarray(err), jnp.asarray(rem))
    got = ttol.next_step_size(torch.from_numpy(h), torch.from_numpy(err),
                              torch.from_numpy(rem))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_precision_presets(preset):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    p, jp = PrecisionPolicy(preset), JPolicy(preset)
    # building any preset turns TF32 off for both matmul and cuDNN
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    name = lambda d: str(d).replace("torch.", "")
    assert (name(p.compute), name(p.param), name(p.state)) == (
        jp.compute_dtype, jp.param_dtype, jp.state_dtype)
    assert p.control == torch.float32
    with pytest.raises(ValueError):
        PrecisionPolicy("fp8")


@pytest.mark.parametrize("name", ["ve10", "vp"])
def test_analytic_oracles(name):
    js, ts = SDES[name]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    t = rng.uniform(js.t_eps, 1.0, 6).astype(np.float32)
    want = jan.gaussian_score(js)(jnp.asarray(x), jnp.asarray(t))
    got = tan.gaussian_score(ts)(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    want = jan.gaussian_noise_pred(js)(None, jnp.asarray(x), jnp.asarray(t))
    got = tan.gaussian_noise_pred(ts)(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(tan.gaussian_marginal_moments(ts),
                               jan.gaussian_marginal_moments(js), rtol=1e-6)
    assert tan.gaussian_w2(0.1, 0.5, 0.3, 0.4) == jan.gaussian_w2(0.1, 0.5, 0.3, 0.4)


@pytest.mark.parametrize("name", sorted(SDES))
def test_drifts(name):
    """f, the reverse-SDE drift f − g²·s and the probability-flow drift
    f − ½g²·s against the reference, on (B, H, W, C) states."""
    js, ts = SDES[name]
    rng = np.random.default_rng(5)
    x, s = (rng.standard_normal((6, 4, 4, 2)).astype(np.float32) for _ in range(2))
    t = rng.uniform(js.t_eps, 1.0, 6).astype(np.float32)
    jx, jsc, jt = jnp.asarray(x), jnp.asarray(s), jnp.asarray(t)
    tx, tsc, tt = torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(t)
    np.testing.assert_allclose(ts.drift(tx, tt).numpy(), _np(js.drift(jx, jt)), **TOL)
    np.testing.assert_allclose(ts.reverse_drift(tx, tt, tsc).numpy(),
                               _np(js.reverse_drift(jx, jt, jsc)), **TOL)
    np.testing.assert_allclose(ts.ode_drift(tx, tt, tsc).numpy(),
                               _np(js.ode_drift(jx, jt, jsc)), **TOL)


@pytest.mark.parametrize("name", ["ve", "vp", "subvp"])
def test_drift_coeff_linearity(name):
    """Mirror of tests/test_sde.py::test_drift_coeff_linearity: every drift
    is linear, f(x, t) = a(t)·x."""
    sde = tsde.get_sde(name)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 5)).astype(np.float32))
    t = torch.linspace(0.1, 0.9, 4)
    a = sde.drift_coeff(t)
    np.testing.assert_allclose(sde.drift(x, t).numpy(), (a[:, None] * x).numpy(),
                               rtol=1e-6, atol=1e-7)
