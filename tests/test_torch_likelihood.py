"""The probability-flow likelihood (``repro_torch.core.likelihood``):
against the reference's ``repro.core.likelihood`` and, as
``tests/test_likelihood.py`` checks the reference, against closed forms.

Bounds: against the reference with the exact divergence, atol 1e-4 nats
— the same fp32 RK4 steps and Jacobian traces, summed over 100 steps in
another rounding order (measured ≤ 3e-6). Against the closed form and
Hutchinson against exact: the reference's own bounds (0.15 and 0.5
nats), which hold the integration error and the probes' variance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as jan
from repro.core import sde as jsde
from repro.core.likelihood import bits_per_dim as jbpd
from repro.core.likelihood import log_likelihood as jll
from repro_torch.core import analytic as tan
from repro_torch.core import sde as tsde
from repro_torch.core.likelihood import bits_per_dim, log_likelihood

torch.set_num_threads(2)

SDES = {"vp": (jsde.VPSDE(), tsde.VPSDE()),
        "ve": (jsde.VESDE(sigma_max=10.0), tsde.VESDE(sigma_max=10.0))}


def _gaussian_data(shape, mu=0.3, s0=0.5, seed=0):
    return (mu + s0 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SDES))
def test_exact_divergence_matches_reference(name):
    """A 2-D Gaussian with its exact score, exact divergence, both sides."""
    js, ts = SDES[name]
    x = _gaussian_data((8, 2))
    want = jll(js, jan.gaussian_score(js, 0.3, 0.5), jnp.asarray(x), n_steps=100)
    got = log_likelihood(ts, tan.gaussian_score(ts, 0.3, 0.5), torch.from_numpy(x),
                         n_steps=100, device="cpu")
    assert got.shape == (8,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    got_bpd = bits_per_dim(ts, tan.gaussian_score(ts, 0.3, 0.5), torch.from_numpy(x),
                           n_steps=100, device="cpu")
    want_bpd = jbpd(js, jan.gaussian_score(js, 0.3, 0.5), jnp.asarray(x), n_steps=100)
    np.testing.assert_allclose(got_bpd.numpy(), np.asarray(want_bpd), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(SDES))
def test_gaussian_loglik_exact(name):
    """Mirror of tests/test_likelihood.py::test_gaussian_loglik_exact."""
    _, ts = SDES[name]
    mu, s0 = 0.3, 0.5
    x = _gaussian_data((16, 4), seed=1)
    ll = log_likelihood(ts, tan.gaussian_score(ts, mu, s0), torch.from_numpy(x),
                        n_steps=300, device="cpu")
    want = -0.5 * (np.sum(((x - mu) / s0) ** 2, axis=1) + 4 * np.log(2 * np.pi * s0 * s0))
    np.testing.assert_allclose(ll.numpy(), want, rtol=0.0, atol=0.15)


def _anisotropic_score(sde, scales):
    """Exact score of N(0, diag(scales²)) data: a Jacobian that is not a
    multiple of the identity, so Hutchinson probes have variance."""
    s2 = torch.as_tensor(scales, dtype=torch.float32) ** 2

    def score(x, t):
        m, std = sde.marginal(t)
        return -x / (m[:, None] ** 2 * s2 + std[:, None] ** 2)

    return score


def test_hutchinson_agrees_with_exact():
    """Mirror of tests/test_likelihood.py::test_hutchinson_agrees_with_exact,
    here on an anisotropic Gaussian, with probes from a torch generator."""
    ts = tsde.VPSDE()
    score = _anisotropic_score(ts, [0.3, 0.5, 0.8, 1.0, 1.5, 2.0])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 6)).astype(np.float32))
    ll_e = log_likelihood(ts, score, x, n_steps=150, device="cpu")
    ll_h = log_likelihood(ts, score, x, n_steps=150, method="hutchinson",
                          generator=torch.Generator().manual_seed(0), probes=64,
                          device="cpu")
    np.testing.assert_allclose(ll_h.numpy(), ll_e.numpy(), atol=0.5)
    again = log_likelihood(ts, score, x, n_steps=150, method="hutchinson",
                           generator=torch.Generator().manual_seed(0), probes=64,
                           device="cpu")
    assert torch.equal(again, ll_h)  # the generator fixes the probes


def test_higher_density_points_score_higher():
    """Mirror of tests/test_likelihood.py::test_higher_density_points_score_higher."""
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, 0.0, 0.5)
    x = torch.cat([torch.zeros(4, 3), torch.full((4, 3), 2.0)])
    ll = log_likelihood(ts, score, x, n_steps=150, device="cpu")
    assert float(ll[:4].min()) > float(ll[4:].max())


def test_image_shaped_input_and_bad_arguments():
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts)
    x = torch.from_numpy(_gaussian_data((2, 2, 2, 1), seed=3))
    flat = log_likelihood(ts, score, x.reshape(2, 4), n_steps=20, device="cpu")
    assert torch.allclose(log_likelihood(ts, score, x, n_steps=20, device="cpu"), flat)
    with pytest.raises(ValueError, match="generator"):
        log_likelihood(ts, score, x, method="hutchinson", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        log_likelihood(ts, score, x, method="trace", device="cpu")
