"""Algorithm 2 (``repro_torch.core.solvers.adaptive.adaptive_forward``):
parity with the reference and its distributional checks.

Parity: the port is handed the reference's own draws through
``noise_fn``, replayed from the reference's key threading (one
``split(key, 3)`` before the loop and one every iteration: z from the
second key, s ~ U{−1, +1} from the third), and must take the same
decisions: per-sample ``nfe``, ``accepted`` and ``rejected`` exactly
equal, ``iterations`` equal, and x within the bound of the Algorithm-1
parity tests (``tests/test_torch_adaptive.py``): rtol 1e-4 and 1e-5 of
the largest |x|, since XLA fuses multiply-adds that torch rounds twice
and the differences compound over the trajectory. The other tests
mirror ``tests/test_solvers.py``'s Algorithm-2 rows and
``tests/test_solver_chunking.py::test_rejection_retains_noise_without_bias``
with the port's own generator.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import ForwardAdaptiveConfig as TFwd
from repro_torch.core import adaptive_forward as t_forward

jad = importlib.import_module("repro.core.solvers.adaptive")

torch.set_num_threads(2)


class ReferenceForwardNoise:
    """``noise_fn`` replaying the reference's Algorithm-2 draws."""

    def __init__(self, key):
        self.key = key

    def __call__(self, x):
        self.key, kz, ks = jax.random.split(self.key, 3)
        z = jax.random.normal(kz, x.shape, jnp.float32)
        s = jax.random.rademacher(ks, (x.shape[0],), jnp.float32)
        return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(s))


CASES = {
    # additive noise: Stratonovich (s = 0), as the config's comment advises
    "ou": (lambda x, t: -1.0 * x, lambda x, t: 0.8 * jnp.ones_like(x),
           lambda x, t: -1.0 * x, lambda x, t: torch.full_like(x, 0.8), 2.0,
           dict(eps_abs=1e-2, stratonovich=True)),
    "gbm": (lambda x, t: 0.05 * x, lambda x, t: 0.2 * x,
            lambda x, t: 0.05 * x, lambda x, t: 0.2 * x, 1.0, dict(eps_abs=1e-3)),
    "gbm-stratonovich": (lambda x, t: 0.05 * x, lambda x, t: 0.2 * x,
                         lambda x, t: 0.05 * x, lambda x, t: 0.2 * x, 1.0,
                         dict(eps_abs=1e-3, stratonovich=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decisions_match_reference(name):
    jf, jg, tf, tg, t_end, kw = CASES[name]
    x0 = (1.0 + 0.1 * np.random.default_rng(0).standard_normal((64, 2))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    cfg = dict(eps_rel=0.05, h_init=0.1, **kw)
    want = jax.jit(lambda x, k: jad.adaptive_forward(
        jf, jg, x, 0.0, t_end, k, config=jad.ForwardAdaptiveConfig(**cfg)))(
        jnp.asarray(x0), key)
    got = t_forward(tf, tg, torch.from_numpy(x0), 0.0, t_end,
                    noise_fn=ReferenceForwardNoise(key), config=TFwd(**cfg), device="cpu")
    for field in ("nfe", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.iterations) == int(want.iterations)
    want_x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(want_x).max())))
    assert int(got.rejected.sum()) > 0


def test_max_iters_cap_matches_reference():
    jf, jg, tf, tg, t_end, _ = CASES["ou"]
    x0 = np.zeros((8, 1), np.float32)
    key = jax.random.PRNGKey(2)
    for cap in (3, 13):
        want = jad.adaptive_forward(jf, jg, jnp.asarray(x0), 0.0, t_end, key,
                                    config=jad.ForwardAdaptiveConfig(max_iters=cap))
        got = t_forward(tf, tg, torch.from_numpy(x0), 0.0, t_end,
                        noise_fn=ReferenceForwardNoise(key),
                        config=TFwd(max_iters=cap), device="cpu")
        assert int(got.iterations) == int(want.iterations) == cap
        np.testing.assert_array_equal(got.nfe.numpy(), np.asarray(want.nfe))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_forward_adaptive_ou_process():
    """dx = λx dt + σ dw: stationary N(0, σ²/(2|λ|)). The reference's test
    takes eps_abs 1e-2; with the Itô s = ±1 on an additive noise that
    needs steps of (δ/σ)² and 26k iterations, 12 s in the port's eager
    loop on a CPU, so the mirror takes 2e-2 (6.6k iterations)."""
    lam, sigma = -1.0, 0.8
    res = t_forward(lambda x, t: lam * x, lambda x, t: torch.full_like(x, sigma),
                    torch.zeros(1024, 1), 0.0, 4.0, _gen(),
                    config=TFwd(eps_abs=2e-2, eps_rel=0.05), device="cpu")
    want_std = sigma / (2.0 * abs(lam)) ** 0.5
    assert float(res.x.mean()) == pytest.approx(0.0, abs=0.05)
    assert float(res.x.std()) == pytest.approx(want_std, rel=0.08)


def test_forward_adaptive_state_dependent_diffusion():
    """g(x, t) = 0.2·x exercises the Itô s = ±1 correction; moments follow
    the exact geometric Brownian motion."""
    mu, sig = 0.05, 0.2
    res = t_forward(lambda x, t: mu * x, lambda x, t: sig * x, torch.ones(4096, 1), 0.0,
                    1.0, _gen(1), config=TFwd(eps_abs=1e-3, eps_rel=0.01), device="cpu")
    assert float(res.x.mean()) == pytest.approx(math.exp(mu), rel=0.02)
    want_var = math.exp(2 * mu) * (math.exp(sig ** 2) - 1.0)
    assert float(res.x.var()) == pytest.approx(want_var, rel=0.25)


def test_extrapolation_is_second_order():
    """On a deterministic drift the achieved error scales as NFE^-p with
    p ≥ 1.5 (Euler–Maruyama alone gives 1)."""
    lam = -2.0
    errs, nfes = [], []
    for eps in (1e-2, 1e-4):
        res = t_forward(lambda x, t: lam * x, lambda x, t: torch.zeros_like(x),
                        torch.ones(4, 1), 0.0, 1.0, _gen(),
                        config=TFwd(eps_abs=eps, eps_rel=eps, h_init=1e-3), device="cpu")
        errs.append(abs(float(res.x.mean()) - math.exp(lam)))
        nfes.append(float(res.nfe.float().mean()))
    p = math.log(errs[0] / max(errs[1], 1e-12)) / math.log(nfes[1] / nfes[0])
    assert p > 1.5, (errs, nfes, p)


def test_rejection_retains_noise_without_bias():
    """z is kept across rejections: a redraw would select small-|z| draws
    and shrink the OU process's stationary variance."""
    lam, sigma = -1.0, 0.8
    cfg = TFwd(eps_abs=2e-2, eps_rel=0.1, h_init=0.1)
    res = t_forward(lambda x, t: lam * x, lambda x, t: torch.full_like(x, sigma),
                    torch.zeros(1024, 2), 0.0, 4.0, _gen(2), config=cfg, device="cpu")
    assert int(res.iterations) < cfg.max_iters
    assert int(res.rejected.sum()) > 10 * res.x.shape[0]
    want_std = sigma / (2.0 * abs(lam)) ** 0.5
    assert float(res.x.mean()) == pytest.approx(0.0, abs=0.04)
    assert float(res.x.std()) == pytest.approx(want_std, rel=0.06)
