"""The trajectory rows of the conformance suite on the CPU: the mirror of
``tests/test_solver_conformance.py::test_trajectory_workload_conformance``
(``TRAJ_SOLVERS`` × ``{vp,ve}:traj16x6``) through the port's own solves. On
the closed-form OU trajectory prior at (B, H, D) = (512, 16, 6) every
zoo family passes its own W2 gate at the image workload's default
tolerances (``zoo_cases``), and the adaptive family does it at equal
error to EM-1000 (up to the Monte-Carlo floor) with fewer NFE.
"""

import functools
import math

import pytest
import torch

from repro_torch.analysis.solver_select import zoo_cases
from repro_torch.core import analytic as tan
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VESDE, VPSDE

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
BATCH, TRAJ_H, TRAJ_D = 512, 16, 6
TRAJ_SOLVERS = ["adaptive", "momentum", "heun", "pc_hmc"]
ADAPTIVE_FAMILY = ("adaptive", "momentum", "heun")
SDES = {"vp": VPSDE(), "ve": VESDE(sigma_max=10.0)}


def _moments(x):
    x = x.to(torch.float64)
    return x.mean().item(), x.std(unbiased=False).item()


def _solve(sde, method, **kw):
    return sample(sde, tan.gaussian_score(sde, MU, S0), (BATCH, TRAJ_H, TRAJ_D), seed=0,
                  method=method, denoise=False, device="cpu", **kw)


@functools.lru_cache(maxsize=2)
def _em_1000(sde_name):
    return _solve(SDES[sde_name], "em", n_steps=1000)


@pytest.mark.parametrize("sde_name", sorted(SDES))
@pytest.mark.parametrize("solver", TRAJ_SOLVERS)
def test_trajectory_workload_conformance(solver, sde_name):
    sde = SDES[sde_name]
    kw, tol = zoo_cases()[solver]
    res = _solve(sde, solver, **kw)
    mu_a, s_a = tan.gaussian_marginal_moments(sde, MU, S0)
    w2 = tan.gaussian_w2(*_moments(res.x), mu_a, s_a)
    assert torch.isfinite(res.x).all()
    assert w2 < tol, (solver, sde_name, w2)
    if solver in ADAPTIVE_FAMILY:
        em = _em_1000(sde_name)
        w2_em = tan.gaussian_w2(*_moments(em.x), mu_a, s_a)
        mc_floor = 3.0 * s_a / math.sqrt(BATCH * TRAJ_H * TRAJ_D)
        assert w2 <= w2_em + 2 * mc_floor + 0.02, (w2, w2_em)
        assert float(res.mean_nfe) < float(em.mean_nfe)
