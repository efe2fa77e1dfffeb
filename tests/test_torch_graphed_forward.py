"""Algorithm 2 (``adaptive_forward``) as a graphed loop, on the CPU: with a
``SlotStreams`` and no ``noise_fn`` its solve is one window of the cached
driver (``adaptive.solve_cached``; on the CPU the plain driver), bitwise
the host-driven groups fed the same stream draws through ``noise_fn``, on
an OU process and on a state-dependent g. Also the draw (z at the row's
counter, s the sign of the normal at counter + 1), the one-shot rule, and
the graphed solve on streams against the reference fed the same draws.
The card's WHILE node is gated in ``chip_smoke.py`` phase 4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import ForwardAdaptiveConfig as TFwd
from repro_torch.core import adaptive_forward as t_forward
from repro_torch.core.sampling import seed_streams
from repro_torch.core.solvers import adaptive as ad

jad = importlib.import_module("repro.core.solvers.adaptive")

torch.set_num_threads(2)

FIELDS = ("x", "nfe", "accepted", "rejected", "iterations")
#: (drift, diffusion, t_end, config): an OU process (additive noise,
#: Stratonovich) and a geometric Brownian motion (g = 0.2·x, Itô s = ±1)
CASES = {
    "ou": (lambda x, t: -1.0 * x, lambda x, t: torch.full_like(x, 0.8), 2.0,
           dict(eps_rel=0.05, eps_abs=5e-2, h_init=0.1, stratonovich=True)),
    "gbm": (lambda x, t: 0.05 * x, lambda x, t: 0.2 * x, 1.0,
            dict(eps_rel=0.05, eps_abs=1e-3, h_init=0.1)),
    "gbm-capped": (lambda x, t: 0.05 * x, lambda x, t: 0.2 * x, 1.0,
                   dict(eps_rel=0.05, eps_abs=1e-3, h_init=0.1, max_iters=13)),
}


class ForwardReplay:
    """``noise_fn`` handing out a ``SlotStreams``' Algorithm-2 draws in
    order: the k-th call is ``_forward_draw`` at counter + 2k."""

    def __init__(self, streams):
        self.streams, self.k = streams, 0

    def __call__(self, x):
        z, s = ad._forward_draw(self.streams, x, ad.FORWARD_DRAWS * self.k)
        self.k += 1
        return z, s


@pytest.fixture(autouse=True)
def _empty_cache():
    ad.clear_graph_cache()
    yield
    ad.clear_graph_cache()


def _x0(shape=(32, 3)):
    return torch.from_numpy(
        (1.0 + 0.1 * np.random.default_rng(0).standard_normal(shape)).astype(np.float32))


def _assert_same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", sorted(CASES))
def test_driver_is_the_host_loop_on_the_same_draws(name):
    f, g, t_end, kw = CASES[name]
    x0 = _x0()
    st = seed_streams(5, x0.shape[0], "cpu")
    solve = lambda: t_forward(f, g, x0, 0.0, t_end, st, config=TFwd(**kw), device="cpu")
    first = solve()  # host-driven
    assert not ad._drivers
    graphed = solve()
    assert len(ad._drivers) == 1
    host = t_forward(f, g, x0, 0.0, t_end, config=TFwd(**kw), device="cpu",
                     noise_fn=ForwardReplay(st))
    for res in (first, graphed, solve()):
        _assert_same(res, host)
    assert int(host.rejected.sum()) > 0 and torch.isfinite(host.x).all()
    if "max_iters" in kw:
        assert int(host.iterations) == kw["max_iters"]


def test_one_shot_rule_and_the_key():
    """0, 1, 0 drivers built over three solves at a key; the key holds the
    functions, the config, t_end and the state's shape."""
    f, g, t_end, kw = CASES["gbm"]
    x0 = _x0()
    st = seed_streams(1, x0.shape[0], "cpu")
    built = []
    for _ in range(3):
        n = len(ad._drivers)
        t_forward(f, g, x0, 0.0, t_end, st, config=TFwd(**kw), device="cpu")
        built.append(len(ad._drivers) - n)
    assert built == [0, 1, 0]
    key = next(iter(ad._drivers))
    assert key.family == "forward" and key.static == (TFwd(**kw), t_end)
    assert len(key.fns) == 2


def test_draw_is_z_then_the_sign_of_one_normal():
    st = seed_streams(3, 6, "cpu")
    x = torch.zeros(6, 4)
    z, s = ad._forward_draw(st, x, 2)
    assert torch.equal(z, st.draw((4,), 2))
    n = st.draw((1,), 3)[:, 0]
    assert torch.equal(s, torch.where(n < 0, -1.0, 1.0))
    assert set(s.tolist()) <= {-1.0, 1.0}


def test_generator_and_noise_fn_keep_the_host_loop():
    f, g, t_end, kw = CASES["gbm"]
    x0 = _x0()
    for _ in range(3):
        t_forward(f, g, x0, 0.0, t_end, torch.Generator().manual_seed(0), config=TFwd(**kw),
                  device="cpu")
        t_forward(f, g, x0, 0.0, t_end, config=TFwd(**kw), device="cpu",
                  noise_fn=ForwardReplay(seed_streams(0, x0.shape[0], "cpu")))
    assert not ad._drivers and not ad._seen


def test_stream_moments_follow_the_exact_gbm():
    """The graphed solve on streams samples the geometric Brownian motion:
    E x(1) = e^μ."""
    mu, sig = 0.05, 0.2
    x0 = torch.ones(2048, 1)
    st = seed_streams(7, x0.shape[0], "cpu")
    f, g = lambda x, t: mu * x, lambda x, t: sig * x
    for _ in range(2):
        res = t_forward(f, g, x0, 0.0, 1.0, st, config=TFwd(eps_abs=1e-3, eps_rel=0.02),
                        device="cpu")
    assert len(ad._drivers) == 1
    assert float(res.x.mean()) == pytest.approx(float(np.exp(mu)), rel=0.02)


@pytest.mark.parametrize("name", ["ou", "gbm"])
def test_streams_match_the_reference_fed_those_draws(monkeypatch, name):
    """The graphed solve on streams against the reference's Algorithm 2
    with ``split(key, 3)``, ``normal`` and ``rademacher`` patched to hand
    it the same draws (its key a draw index), at the Algorithm-2 parity
    bounds of ``test_torch_adaptive_forward.py``."""
    f, g, t_end, kw = CASES[name]
    jf = {"ou": lambda x, t: -1.0 * x, "gbm": lambda x, t: 0.05 * x}[name]
    jg = {"ou": lambda x, t: 0.8 * jnp.ones_like(x), "gbm": lambda x, t: 0.2 * x}[name]
    x0 = _x0((16, 2))
    st = seed_streams(2, x0.shape[0], "cpu")
    for _ in range(2):
        got = t_forward(f, g, x0, 0.0, t_end, st, config=TFwd(**kw), device="cpu")
    assert len(ad._drivers) == 1
    n = int(got.iterations) + 1
    draws = [ad._forward_draw(st, x0, ad.FORWARD_DRAWS * k) for k in range(n)]
    zs = jnp.asarray(np.stack([z.numpy() for z, _ in draws]))
    ss = jnp.asarray(np.stack([s.numpy() for _, s in draws]))
    monkeypatch.setattr(jax.random, "split", lambda k, num=2: (k + 1,) + (k,) * (num - 1))
    monkeypatch.setattr(jax.random, "normal", lambda k, shape, dtype=jnp.float32: zs[k])
    monkeypatch.setattr(jax.random, "rademacher", lambda k, shape, dtype=jnp.float32: ss[k])
    want = jad.adaptive_forward(jf, jg, jnp.asarray(x0.numpy()), 0.0, t_end,
                                jnp.asarray(0, jnp.int32),
                                config=jad.ForwardAdaptiveConfig(**kw))
    for field in ("nfe", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.iterations) == int(want.iterations)
    want_x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(want_x).max())))
