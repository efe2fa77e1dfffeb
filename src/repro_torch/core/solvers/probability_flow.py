"""Probability-flow ODE baseline solved with adaptive RK45
(Dormand–Prince 5(4)); port of ``repro/core/solvers/probability_flow.py``.

Song et al. 2020a solve dx = [f(x,t) − ½ g(t)² s(x,t)] dt with scipy's
RK45 at rtol = atol = 1e-5. The error control is global over the whole
flattened batch, as scipy's, so the NFE is batch-global; FSAL reuses the
last stage of an accepted step as the next step's first, so an attempt
costs 6 evaluations after one seeding evaluation.

The reference runs a device-side ``lax.while_loop``. Here the attempts
run in masked groups of ``SYNC_EVERY`` with one host sync per group, as
in ``adaptive.solve_chunk``: an attempt made once s has reached the span
(or the attempt budget is spent) changes nothing, and ``iterations`` and
``nfe`` count only the attempts made while s < span, so both equal the
reference's. s and h stay fp32 tensors, and the tableau is kept as the
reference keeps it (``_C``, ``_B5``, ``_B4`` fp32 arrays, ``_A`` Python
floats), so the step sizes and accept decisions round as there.

The error is the reference's whole-batch RMS of the scaled residual
(``probability_flow.py:81`` there), summed in two stages: each row's sum
of squares, then the (B,) row sums. Under a mesh (``sharding``) each rank
holds its rows' sums in a zero-filled (B,) vector, and one
``all_reduce(SUM)`` of that vector (adding zeros is exact) gives every
rank the unsharded row sums bit for bit, so every rank takes the same
accept/reject and step size as the unsharded solve.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.sde import SDE
from repro_torch.core.solvers.adaptive import SYNC_EVERY
from repro_torch.core.solvers.base import (
    SolveResult, local_state, register_solver, tweedie_tail,
)
from repro_torch.device import resolve_device

Tensor = torch.Tensor

# Dormand–Prince Butcher tableau
_C = torch.tensor([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5 = torch.tensor([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_B4 = torch.tensor([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
                    187 / 2100, 1 / 40])


@register_solver("ode", nfe_per_iter=6)
def probability_flow_rk45(sde: SDE, score_fn: Callable, x_init: Tensor,
                          generator: torch.Generator | None = None, *,
                          rtol: float = 1e-5, atol: float = 1e-5,
                          h_init: float = 0.01, max_iters: int = 100_000,
                          denoise: bool = True, noise_fn: Callable | None = None,
                          device="cuda", sharding=None) -> SolveResult:
    """Integrate the probability-flow ODE from T to t_eps on ``device``.
    Deterministic: ``generator`` and ``noise_fn`` are accepted for a
    uniform API and not used. Under a mesh (``sharding``) the rank
    integrates its rows with the batch-global error (module docstring)."""
    del generator, noise_fn
    dev = resolve_device(device)
    x = local_state(x_init, dev, sharding)
    batch = x.shape[0]
    sharded = sharding is not None and not sharding.replicated
    n_total = x_init.numel()
    f32 = dict(dtype=torch.float32, device=dev)
    C, B5, B4 = (a.to(dev) for a in (_C, _B5, _B4))
    T = torch.tensor(sde.T, **f32)
    span = sde.T - sde.t_eps
    span32 = torch.tensor(span, **f32)
    stop32 = torch.tensor(span - 1e-12, **f32)

    def f(x: Tensor, t: Tensor) -> Tensor:
        """Reverse-time ODE drift as dx/ds with s = T − t (s runs up)."""
        tt = t.expand(batch).contiguous()
        return -sde.ode_drift(x, tt, score_fn(x, tt))

    def global_sum_sq(r: Tensor) -> Tensor:
        """Σ r² over the whole batch: per row, then over the rows."""
        rows = torch.sum((r * r).reshape(batch, -1), dim=1)
        if sharded:
            full = rows.new_zeros(sharding.batch)
            full[sharding.rows] = rows
            dist.all_reduce(full, op=dist.ReduceOp.SUM, group=sharding.mesh.group())
            rows = full
        return torch.sum(rows)

    def attempt(x, s, h, nfe, iters, k1):
        active = (s < stop32) & (iters < max_iters)
        h = torch.minimum(h, span32 - s)
        ks = [k1]
        for i in range(1, 7):
            xi = x
            for j, a in enumerate(_A[i]):
                xi = xi + h * a * ks[j]
            ks.append(f(xi, T - (s + C[i] * h)))
        x5 = x4 = x
        for i in range(7):
            x5 = x5 + h * B5[i] * ks[i]
            x4 = x4 + h * B4[i] * ks[i]
        scale = atol + rtol * torch.maximum(torch.abs(x), torch.abs(x5))
        err = torch.sqrt(global_sum_sq((x5 - x4) / scale) / n_total)  # global norm
        accept = (err <= 1.0) & active
        factor = torch.clamp(0.9 * err ** (-0.2), 0.2, 10.0)
        step = active.to(torch.int32)
        return (torch.where(accept, x5, x), torch.where(accept, s + h, s),
                torch.where(active, h * factor, h), nfe + 6 * step, iters + step,
                torch.where(accept, ks[6], k1))  # FSAL: k7 is the next k1

    with torch.no_grad():
        state = (x, torch.zeros((), **f32), torch.tensor(h_init, **f32),
                 torch.ones((), dtype=torch.int32, device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev), f(x, T))
        running, done_iters = True, 0
        while running and done_iters < max_iters:
            for _ in range(min(SYNC_EVERY, max_iters - done_iters)):
                state = attempt(*state)
            _, s, _, _, iters, _ = state
            flags = torch.stack([(s < stop32).to(torch.int32), iters]).tolist()
            running, done_iters = bool(flags[0]), flags[1]  # one host sync
        x, _, _, nfe, iters, _ = state
        if denoise:
            x = tweedie_tail(sde, score_fn, x)
            nfe = nfe + 1
    zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return SolveResult(x=x, nfe=nfe.expand(batch).contiguous(), iterations=iters,
                       accepted=zeros, rejected=zeros)
