"""Fixed-step Euler–Maruyama for the reverse diffusion (the paper's
baseline); port of ``repro/core/solvers/euler_maruyama.py``.

Time follows t_0 = T, t_i = t_{i-1} − (T − t_eps)/N (paper App. D); the
solver stops at t = t_eps and the sample is then denoised with the
corrected Tweedie formula. Each step is

    x ← x − h·(a(t)·x − g(t)²·s) + √h·g(t)·z,

which is K5's form x ← c0·x + c1·s + c2·z with c0 = 1 − h·a(t),
c1 = h·g(t)², c2 = √h·g(t): the update goes through
``kernels.solver_step.ops.em_step`` (the CUDA kernel on the card, its
plain version on the CPU). The reference subtracts h·drift; K5
distributes h, so the two agree to a few fp32 ulps per step, not
bitwise.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.sde import SDE
from repro_torch.core.solvers import grid
from repro_torch.core.solvers.adaptive import graphable
from repro_torch.core.solvers.base import (
    SolveResult, check_noise_source, draw_noise, fixed_grid_result, fma32,
    local_state, register_solver, tweedie_tail,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.solver_step import ops as step_ops

Tensor = torch.Tensor


def em_times(sde: SDE, n_steps: int, device=None) -> Tensor:
    """The (n_steps,) fp32 grid t_i = T − i·h, h = (T − t_eps)/n_steps,
    bit for bit as the reference computes it: h is a Python double, i and
    h are converted to fp32, and XLA's CPU code contracts T − i·h into one
    fused multiply-add."""
    h = (sde.T - sde.t_eps) / n_steps
    f32 = dict(dtype=torch.float32, device=device)
    i = torch.arange(n_steps, **f32)
    return fma32(-i, torch.tensor(h, **f32), torch.tensor(sde.T, **f32))


def k5(x: Tensor, score: Tensor, z: Tensor, c0: Tensor, c1: Tensor,
       c2: Tensor) -> Tensor:
    """x ← c0·x + c1·score + c2·z through K5, with (B,) fp32 coefficients
    (a 0-d coefficient is broadcast over the batch)."""
    batch = x.shape[0]
    c0, c1, c2 = (c.to(torch.float32).expand(batch).contiguous() for c in (c0, c1, c2))
    return step_ops.em_step(x, score.to(x.dtype).contiguous(), z.contiguous(),
                            c0, c1, c2)


@register_solver("em", nfe_per_iter=1)
def euler_maruyama(sde: SDE, score_fn: Callable, x_init: Tensor,
                   generator=None, *, n_steps: int = 1000, denoise: bool = True,
                   noise_fn: Callable | None = None,
                   device="cuda", sharding=None) -> SolveResult:
    """``n_steps`` reverse EM steps from T to t_eps on ``device``: one
    score evaluation and one K5 launch per step. Noise: one draw per step,
    from ``generator`` (a ``SlotStreams``, the row's stream one counter a
    step; a ``torch.Generator``; per-slot sources) or ``noise_fn`` (under
    a mesh the whole batch's, cut to this rank's rows of ``sharding``).
    With a ``SlotStreams`` and no ``noise_fn`` (under a mesh on the card,
    an NCCL mesh: ``graphable``) the grid runs as one captured CUDA graph
    (``grid.run_grid``), bitwise the host-driven loop."""
    dev = resolve_device(device)
    check_noise_source(generator, noise_fn, dev, "em")
    x = local_state(x_init, dev, sharding)
    batch = x.shape[0]

    def make_step(score):
        T, _ = grid.ends(sde)

        def step(c: grid.GridCarry) -> grid.GridCarry:
            t = grid.em_time(c, T).expand(batch).contiguous()
            z = draw_noise(c.generator, noise_fn, c.x, sharding)
            s = score(c.x, t)
            g = sde.diffusion(t)
            x = k5(c.x, s, z, 1.0 - c.h * sde.drift_coeff(t), c.h * g * g, c.sqrt_h * g)
            return grid.advance(c, x, 1)

        return step

    carry = grid.init_grid(sde, x, n_steps, generator, sharding)
    carry = grid.run_grid("em", sde, score_fn, carry, n_steps, make_step,
                          graphed=graphable(generator, noise_fn, sharding), sharding=sharding)
    with torch.no_grad():
        res = fixed_grid_result(carry.x, n_steps, 1)
        if denoise:
            res.x = tweedie_tail(sde, score_fn, carry.x)
            res.nfe = res.nfe + 1
    return res
