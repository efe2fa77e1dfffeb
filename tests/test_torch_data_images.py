"""Port ↔ reference parity: the synthetic data (``repro_torch.data``).

``GMM2D.score_at_time`` against the reference's within 1e-6 (constants
only, the same function); ``sample_images`` with the reference's
generator parameters carried across and its component and latent draws
replayed (``jax.random.split(key)``: components, then z) within 1e-6;
and the port's mirrors of ``tests/test_substrates.py``'s data tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sde as jsde
from repro.data import images as jimg
from repro_torch.core import sde as tsde
from repro_torch.data import images as timg

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["vp", "ve"])
def test_gmm2d_score_matches_reference(name):
    js, ts = {"vp": (jsde.VPSDE(), tsde.VPSDE()),
              "ve": (jsde.VESDE(sigma_max=12.0), tsde.VESDE(sigma_max=12.0))}[name]
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((64, 2))).astype(np.float32)
    t = np.linspace(1e-3, 1.0, 64).astype(np.float32)
    want = jimg.GMM2D().score_at_time(js)(jnp.asarray(x), jnp.asarray(t))
    got = timg.GMM2D().score_at_time(ts)(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_sample_images_with_reference_parameters():
    cfg_j = jimg.GMMImageConfig(image_size=8)
    cfg_t = timg.GMMImageConfig(image_size=8)
    params = [np.asarray(a) for a in jimg._generator_params(cfg_j)]
    key, n = jax.random.PRNGKey(3), 32
    want = jimg.sample_images(cfg_j, key, n)
    kc, kz = jax.random.split(key)
    comp = np.asarray(jax.random.randint(kc, (n,), 0, cfg_j.n_components))
    z = np.asarray(jax.random.normal(kz, (n, cfg_j.latent_dim)))
    got = timg.sample_images(cfg_t, None, n, params=params, comp=torch.from_numpy(comp),
                             z=torch.from_numpy(z))
    assert got.shape == want.shape == (n, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_port_generator_parameters_have_the_reference_family():
    """Another instance of the same family: shapes, scale ranges."""
    cfg = timg.GMMImageConfig(image_size=8)
    means, basis, scales = timg.generator_params(cfg)
    jm, jb, js = (np.asarray(a) for a in jimg._generator_params(jimg.GMMImageConfig(image_size=8)))
    assert means.shape == jm.shape and basis.shape == jb.shape and scales.shape == js.shape
    assert 0.3 <= float(scales.min()) and float(scales.max()) <= 1.0
    assert float(means.std()) == pytest.approx(2.0, rel=0.2)
    assert float(basis.std()) == pytest.approx(0.25, rel=0.1)
    a = timg.sample_images(cfg, torch.Generator().manual_seed(1), 4)
    b = timg.sample_images(cfg, torch.Generator().manual_seed(1), 4)
    assert torch.equal(a, b)


# mirrors of tests/test_substrates.py


def test_gmm_images_in_range():
    cfg = timg.GMMImageConfig(image_size=16)
    x = timg.sample_images(cfg, torch.Generator().manual_seed(0), 64)
    assert x.shape == (64, 16, 16, 3)
    assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0
    mu, var = timg.data_moments(cfg, n=256)
    assert mu.shape == var.shape == (16 * 16 * 3,) and float(var.min()) > 0


def test_gmm2d_score_matches_autodiff():
    """The closed-form mixture score against autograd of the exact
    log-density."""
    gmm, sde = timg.GMM2D(), tsde.VPSDE()
    x = 2.0 * torch.randn(16, 2, generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64)
    t = torch.linspace(0.05, 0.95, 16, dtype=torch.float64)
    means = torch.tensor(gmm.means, dtype=torch.float64)
    w = torch.tensor(gmm.weights, dtype=torch.float64)
    m, s = sde.marginal(t)
    m, s = m.double(), s.double()
    xr = x.clone().requires_grad_(True)
    var = (m * gmm.std) ** 2 + s ** 2
    comp = (-0.5 * torch.sum((xr[:, None, :] - m[:, None, None] * means[None]) ** 2, -1)
            / var[:, None] - torch.log(var)[:, None])
    (want,) = torch.autograd.grad(torch.logsumexp(comp + torch.log(w), -1).sum(), xr)
    got = gmm.score_at_time(sde)(x.float(), t.float())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)


def test_gmm2d_sample_moments():
    x = timg.GMM2D().sample(torch.Generator().manual_seed(0), 8192)
    assert x.shape == (8192, 2)
    np.testing.assert_allclose(x.mean(0).numpy(), 0.0, atol=0.1)
    np.testing.assert_allclose(x.std(0).numpy(), (4.0 + 0.25) ** 0.5, rtol=0.03)
