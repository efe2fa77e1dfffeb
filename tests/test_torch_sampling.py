"""The port's ``sample()`` with its own generator: a distributional gate.

With the port's own noise stream (not the reference's), the samples at
t_eps must match the closed-form OU marginal of Gaussian data under the
gate of the adaptive row of ``tests/test_solver_conformance.py``: batch
512 × dim 8, eps_rel 0.05, no denoise, W2 < 0.08. Every baseline solver
meets its own row of that suite the same way (``zoo_cases``: EM-200,
ODE, DDIM-50 and PC/PC-HMC-100 with their W2 gates; DDIM on VP only).
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis.solver_select import zoo_cases
from repro.core import analytic as jan
from repro.core import sde as jsde
from repro_torch.core import analytic as tan
from repro_torch.core import sde as tsde
from repro_torch.core.sampling import sample

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
BATCH, DIM = 512, 8
KW, W2_GATE = zoo_cases()["adaptive"]

SDES = {"vp": (jsde.VPSDE(), tsde.VPSDE()),
        "ve": (jsde.VESDE(sigma_max=10.0), tsde.VESDE(sigma_max=10.0))}


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("name", sorted(SDES))
def test_sample_matches_analytic_marginal(name, fused):
    js, ts = SDES[name]
    res = sample(ts, tan.gaussian_score(ts, MU, S0), (BATCH, DIM), seed=0,
                 device="cpu", denoise=False, use_fused_kernel=fused, **KW)
    x = res.x.numpy().astype(np.float64)
    assert np.isfinite(x).all() and res.x.shape == (BATCH, DIM)
    mu_a, s_a = jan.gaussian_marginal_moments(js, MU, S0)
    assert tan.gaussian_marginal_moments(ts, MU, S0) == pytest.approx((mu_a, s_a))
    w2 = tan.gaussian_w2(float(x.mean()), float(x.std()), mu_a, s_a)
    assert w2 < W2_GATE, (name, w2)
    assert int(res.rejected.sum()) > 0


def test_seed_determines_the_result():
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    a, b, c = (sample(ts, score, (16, 4), seed=s, device="cpu", eps_rel=0.05)
               for s in (1, 1, 2))
    assert torch.equal(a.x, b.x) and torch.equal(a.nfe, b.nfe)
    assert not torch.equal(a.x, c.x)


BASELINES = [(m, sn) for m in ("em", "ode", "ddim", "pc", "pc_hmc")
             for sn in sorted(SDES) if not (m == "ddim" and sn == "ve")]


@pytest.mark.parametrize("method,name", BASELINES, ids=[f"{m}-{s}" for m, s in BASELINES])
def test_baseline_matches_analytic_marginal(method, name):
    js, ts = SDES[name]
    kw, gate = zoo_cases()[method]
    res = sample(ts, tan.gaussian_score(ts, MU, S0), (BATCH, DIM), seed=0,
                 method=method, device="cpu", denoise=False, **kw)
    x = res.x.numpy().astype(np.float64)
    assert np.isfinite(x).all() and res.x.shape == (BATCH, DIM)
    mu_a, s_a = jan.gaussian_marginal_moments(js, MU, S0)
    w2 = tan.gaussian_w2(float(x.mean()), float(x.std()), mu_a, s_a)
    assert w2 < gate, (method, name, w2)


def test_sample_chunked_returns_host_numpy_and_exact_values():
    """``sample_chunked`` hands back host numpy, bit for bit the chunks of
    one ``sample`` call each with the chunk seeds, a ragged tail cut off
    (the mirror of ``tests/test_solver_chunking.py``'s test)."""
    from repro_torch.core.sampling import chunk_seeds, sample_chunked

    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    chunk, n = 4, 10  # three chunks, a ragged tail
    x, mean_nfe = sample_chunked(ts, score, n, (8,), seed=5, chunk=chunk, device="cpu",
                                 eps_rel=0.1)
    assert type(x) is np.ndarray and x.shape == (n, 8) and x.dtype == np.float32
    assert isinstance(mean_nfe, float) and mean_nfe > 0
    seeds = chunk_seeds(5, 3)
    assert len(set(seeds)) == 3 and seeds == chunk_seeds(5, 3)
    outs, nfes = [], []
    for s in seeds:
        res = sample(ts, score, (chunk, 8), seed=s, device="cpu", eps_rel=0.1)
        outs.append(res.x.numpy())
        nfes.append(res.nfe.numpy())
    np.testing.assert_array_equal(x, np.concatenate(outs)[:n])
    assert mean_nfe == pytest.approx(float(np.concatenate(nfes)[:n].mean()))
    em, _ = sample_chunked(ts, score, 6, (8,), seed=5, chunk=4, method="em", n_steps=20,
                           device="cpu")
    assert em.shape == (6, 8) and np.isfinite(em).all()


def test_chunk_fn_gives_the_chained_solve_bitwise():
    """A prebuilt ``carry -> carry`` chunk in place of the default one: the
    same bits as ``sample``, and every chunk is the caller's."""
    from repro_torch.core.sampling import solve_in_chunks
    from repro_torch.core.solvers import adaptive as tad

    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    kw = dict(seed=3, device="cpu", eps_rel=0.05)
    mono = sample(ts, score, (6, 5), **kw)
    calls = []

    def chunk_fn(carry):
        calls.append(int(carry.iterations))
        return tad.solve_chunk(ts, score, carry, max_sync_iters=5, eps_rel=0.05)

    got = solve_in_chunks(ts, score, (6, 5), max_sync_iters=1, chunk_fn=chunk_fn, **kw)
    assert torch.equal(got.x, mono.x)
    for name in ("nfe", "accepted", "rejected", "iterations"):
        assert torch.equal(getattr(got, name), getattr(mono, name)), name
    assert calls == list(range(0, 5 * len(calls), 5)) and len(calls) > 1
