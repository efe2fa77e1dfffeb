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

from repro.analysis.solver_select import zoo_cases
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
