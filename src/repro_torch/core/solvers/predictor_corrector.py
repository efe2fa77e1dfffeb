"""Reverse-diffusion (ancestral) predictor + Langevin corrector; port of
``repro/core/solvers/predictor_corrector.py``.

The paper's strongest VE baseline ("Reverse-Diffusion & Langevin",
Table 1), Song et al. 2020a's PC sampler:

  predictor (VE): x ← x + (σ_i² − σ_{i+1}²) s(x, t_i) + √(σ_i² − σ_{i+1}²) z
  predictor (VP): x ← (2 − √(1 − β_i)) x + β_i s(x, t_i) + √β_i z
  corrector     : annealed Langevin with step ε = 2 α (r ‖z‖/‖s‖)²,
                  x ← x + ε s + √(2ε) z

with signal-to-noise ratio r (0.16 for VE, 0.01 for VP) and α = 1 (VE)
or 1 − β(t)/N (VP). Every one of these updates is K5's form
x ← c0·x + c1·s + c2·z, so the predictor and the Langevin corrector go
through ``kernels.solver_step.ops.em_step`` (the CUDA kernel on the
card, its plain version on the CPU); with c0 = 1 the kernel's product
1·x is exact, so those updates round as the reference's.

Corrector seam (DESIGN.md §11): ``corrector="hmc"`` replaces the
Langevin pass with uncorrected Hamiltonian Monte Carlo: p ~ N(0, I), L
leapfrog steps at ε = √(2·step)/L with the score as −∇U, the final
half-kick skipped (p is refreshed next pass). At L = 1 it is the
Langevin update. The leapfrog (x + ε·p, p + ε·s) is plain torch, as it
is plain jnp in the reference.

The grid is the reference's ``jnp.linspace(T, t_eps, N + 1)`` in fp32
as XLA's CPU code rounds it (``linspace_f32``). Noise: one draw per
corrector pass (a Langevin z or an HMC p), then one for the predictor's
z, each from ``generator`` or ``noise_fn``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.sde import SDE, VESDE, bcast
from repro_torch.core.solvers import grid
from repro_torch.core.solvers.adaptive import graphable
from repro_torch.core.solvers.base import (
    SolveResult, check_noise_source, draw_noise, fixed_grid_result, fma32,
    local_state, register_solver, tweedie_tail,
)
from repro_torch.core.solvers.euler_maruyama import k5
from repro_torch.device import resolve_device

Tensor = torch.Tensor


def linspace_f32(start: float, stop: float, num: int, device=None) -> Tensor:
    """``jnp.linspace(start, stop, num)`` in fp32, bit for bit as XLA's CPU
    code computes it (``torch.linspace`` rounds some points otherwise).

    JAX's formula is start·(1 − i/d) + stop·(i/d) with d = num − 1 and the
    last point ``stop`` itself. XLA folds the division into a product with
    r = fp32(1/d) and stop·(i·r) into i·fp32(stop·r), and its CPU code
    fuses the final product and sum into one multiply-add. (Its vectorised
    loop, used from about 60 points on, fuses 1 − i·r as well, so there
    JAX's own points vary with the host's vector width; the parity tests
    hold the grids bitwise up to 51 points.)
    """
    f32 = dict(dtype=torch.float32, device=device)
    a, b = torch.tensor(start, **f32), torch.tensor(stop, **f32)
    if num == 1:
        return a.reshape(1)
    r = torch.tensor(1.0, **f32) / torch.tensor(float(num - 1), **f32)
    i = torch.arange(num - 1, **f32)
    return torch.cat([fma32(i, b * r, a * (1 - i * r)), b.reshape(1)])


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim))))


def _pc_nfe_per_iter(corrector_steps: int = 1, corrector: str = "langevin",
                     hmc_leapfrog: int = 3, **_) -> int:
    """1 predictor evaluation + corrector passes: Langevin costs 1
    evaluation each, HMC its L leapfrog evaluations."""
    per_pass = hmc_leapfrog if corrector == "hmc" else 1
    return 1 + corrector_steps * per_pass


@register_solver("pc", nfe_per_iter=_pc_nfe_per_iter)
def predictor_corrector(sde: SDE, score_fn: Callable, x_init: Tensor,
                        generator=None, *, n_steps: int = 1000, corrector_steps: int = 1,
                        snr: float | None = None, denoise: bool = True,
                        corrector: str = "langevin", hmc_leapfrog: int = 3,
                        noise_fn: Callable | None = None,
                        device="cuda", sharding=None) -> SolveResult:
    """``n_steps`` grid steps on ``device``, each ``corrector_steps``
    corrector passes then one ancestral predictor step. Under a mesh
    (``sharding``) the rank solves its rows: the draws are the whole
    batch's cut to them (a ``SlotStreams``: the rank's rows of the
    streams), and the Langevin step size is per row. A step's draws come
    from a ``SlotStreams`` at fixed offsets: corrector pass k at the
    row's counter + k, the predictor at + ``corrector_steps``, and the
    counter moves on by ``corrector_steps`` + 1. With a ``SlotStreams``
    and no ``noise_fn`` (under a mesh on the card, an NCCL mesh:
    ``graphable``) the grid runs as one captured CUDA graph
    (``grid.run_grid``), bitwise the host-driven loop."""
    dev = resolve_device(device)
    check_noise_source(generator, noise_fn, dev, "pc")
    x = local_state(x_init, dev, sharding)
    batch = x.shape[0]
    is_ve = isinstance(sde, VESDE)
    if snr is None:
        snr = 0.16 if is_ve else 0.01
    span = sde.T - sde.t_eps

    def step_size(t, z, score, nf):
        """snr-derived Langevin step ε = 2 α (r ‖z‖/‖s‖)², shape (B,)."""
        alpha = torch.ones_like(t) if is_ve else 1.0 - sde.beta(t) / nf
        q = snr * _norm(z) / torch.clamp(_norm(score), min=1e-12)
        return 2.0 * alpha * q ** 2

    def langevin(score_fn, gen, x, t, nf, k):
        z = draw_noise(gen, noise_fn, x, sharding, k)
        score = score_fn(x, t)
        step = step_size(t, z, score, nf)
        return k5(x, score, z, torch.ones_like(step), step, torch.sqrt(2.0 * step))

    def hmc(score_fn, gen, x, t, nf, k):
        p = draw_noise(gen, noise_fn, x, sharding, k)
        score = score_fn(x, t)
        step = step_size(t, p, score, nf)
        eps = bcast(torch.sqrt(2.0 * step) / hmc_leapfrog, x)
        p = p + 0.5 * eps * score
        for leap in range(hmc_leapfrog):
            x = x + eps * p
            if leap + 1 < hmc_leapfrog:
                p = p + eps * score_fn(x, t)
        return x

    correctors = {"langevin": (langevin, 1), "hmc": (hmc, hmc_leapfrog)}
    if corrector not in correctors:
        raise ValueError(f"unknown corrector {corrector!r}; have {sorted(correctors)}")
    corrector_fn, evals_per_corrector = correctors[corrector]

    def make_step(score):
        a, b = grid.ends(sde)

        def step(c: grid.GridCarry) -> grid.GridCarry:
            i = c.iterations
            t = grid.linspace_point(c, i, a, b).expand(batch).contiguous()
            nf = c.n_steps.to(torch.float32)
            x = c.x
            for k in range(corrector_steps):
                x = corrector_fn(score, c.generator, x, t, nf, k)
            z = draw_noise(c.generator, noise_fn, x, sharding, corrector_steps)
            s = score(x, t)
            if is_ve:
                t_next = grid.linspace_point(c, i + 1, a, b).expand(batch)
                s_t, s_n = sde.sigma(t), sde.sigma(t_next)
                var = torch.clamp(s_t * s_t - s_n * s_n, min=0.0)
                x = k5(x, s, z, torch.ones_like(var), var, torch.sqrt(var))
            else:
                beta = sde.beta(t) * span / nf  # discrete β_i
                x = k5(x, s, z, 2.0 - torch.sqrt(1.0 - beta), beta, torch.sqrt(beta))
            return grid.advance(c, x, corrector_steps + 1)

        return step

    carry = grid.init_grid(sde, x, n_steps, generator, sharding)
    carry = grid.run_grid("pc", sde, score_fn, carry, n_steps, make_step,
                          static=(corrector, corrector_steps, hmc_leapfrog, snr),
                          graphed=graphable(generator, noise_fn, sharding), sharding=sharding)
    with torch.no_grad():
        res = fixed_grid_result(carry.x, n_steps, 1 + corrector_steps * evals_per_corrector)
        if denoise:
            res.x = tweedie_tail(sde, score_fn, carry.x)
            res.nfe = res.nfe + 1
    return res


def _pc_hmc_nfe_per_iter(corrector_steps: int = 1, hmc_leapfrog: int = 3,
                         **_) -> int:
    return _pc_nfe_per_iter(corrector_steps=corrector_steps, corrector="hmc",
                            hmc_leapfrog=hmc_leapfrog)


@register_solver("pc_hmc", nfe_per_iter=_pc_hmc_nfe_per_iter)
def predictor_corrector_hmc(sde: SDE, score_fn: Callable, x_init: Tensor,
                            generator=None, *,
                            n_steps: int = 1000, corrector_steps: int = 1,
                            snr: float | None = None, denoise: bool = True,
                            hmc_leapfrog: int = 3,
                            noise_fn: Callable | None = None,
                            device="cuda", sharding=None) -> SolveResult:
    """The PC sampler with ``corrector="hmc"`` (DESIGN.md §11):
    ``1 + corrector_steps·L`` evaluations per grid step."""
    return predictor_corrector(
        sde, score_fn, x_init, generator, n_steps=n_steps,
        corrector_steps=corrector_steps, snr=snr, denoise=denoise,
        corrector="hmc", hmc_leapfrog=hmc_leapfrog, noise_fn=noise_fn,
        device=device, sharding=sharding)
