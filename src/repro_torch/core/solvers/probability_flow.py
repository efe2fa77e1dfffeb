"""Probability-flow ODE baseline solved with adaptive RK45
(Dormand–Prince 5(4)); port of ``repro/core/solvers/probability_flow.py``.

Song et al. 2020a solve dx = [f(x,t) − ½ g(t)² s(x,t)] dt with scipy's
RK45 at rtol = atol = 1e-5. The error control is global over the whole
flattened batch, as scipy's, so the NFE is batch-global; FSAL reuses the
last stage of an accepted step as the next step's first, so an attempt
costs 6 evaluations after one seeding evaluation.

The reference runs a device-side ``lax.while_loop`` whose condition,
s < span ∧ iterations < max_iters, it checks after every attempt.
Graphed (no ``noise_fn``, and under a mesh on the card an NCCL mesh;
``adaptive.graphable``), the solve is one window of a cached driver
(``adaptive.solve_cached``): on the card one WHILE-node launch whose
body is one attempt and whose condition (P2) is the reference's, checked
after every attempt, and one host read a solve; a key's first solve is
host-driven (the one-shot rule). Host-driven, the attempts run in
masked groups of ``SYNC_EVERY`` with one host read after each: an
attempt made once s has reached the span (or the attempt budget is
spent) changes nothing, though it runs its six score evaluations, and
``iterations`` and ``nfe`` count only the attempts made while s < span,
so both equal the reference's on both paths and the graphed solve is
the host-driven one bit for bit. Under a mesh the graphed unit stays
the masked group, one a horizon, at most ⌈``max_iters``/``SYNC_EVERY``⌉.
The tolerances and h_init are the
carry's buffers, so one graph serves every tolerance. s and h stay fp32
tensors, and the tableau is kept as the reference keeps it (``_C``,
``_B5``, ``_B4`` fp32 arrays, ``_A`` Python floats), so the step sizes
and accept decisions round as there.

The error is the reference's whole-batch RMS of the scaled residual
(``probability_flow.py:81`` there), summed in two stages: each row's sum
of squares, then the (B,) row sums. Under a mesh (``sharding``) each rank
holds its rows' sums in a zero-filled (B,) vector, and one
``all_reduce(SUM)`` of that vector (adding zeros is exact) gives every
rank the unsharded row sums bit for bit, so every rank takes the same
accept/reject and step size as the unsharded solve. s, and with it the
graphed window's condition, is then the same on every rank by
construction (no flags); on NCCL the all-reduce is captured with the
attempt, one an attempt as on the host-driven path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.sde import SDE
from repro_torch.core.solvers.adaptive import SYNC_EVERY, graphable, host_read, solve_cached
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


@dataclasses.dataclass
class OdeCarry:
    """State of the RK45 between attempts: x (B, ...), s = T − t and h
    (0-d fp32), nfe and iterations (0-d int32), k1 the FSAL stage (x's
    shape), done (1,) bool (s has reached the span: the driver's
    condition, one virtual slot), and the per-solve tolerances rtol and
    atol (0-d fp32 buffers)."""

    x: Tensor
    s: Tensor
    h: Tensor
    nfe: Tensor
    iterations: Tensor
    k1: Tensor
    done: Tensor
    rtol: Tensor
    atol: Tensor


@register_solver("ode", nfe_per_iter=6)
def probability_flow_rk45(sde: SDE, score_fn: Callable, x_init: Tensor,
                          generator=None, *, rtol: float = 1e-5, atol: float = 1e-5,
                          h_init: float = 0.01, max_iters: int = 100_000,
                          denoise: bool = True, noise_fn: Callable | None = None,
                          device="cuda", sharding=None) -> SolveResult:
    """Integrate the probability-flow ODE from T to t_eps on ``device``.
    Deterministic: ``generator`` is accepted for a uniform API and not
    used. Under a mesh (``sharding``) the rank integrates its rows with
    the batch-global error (module docstring). With no ``noise_fn``
    (under a mesh on the card, an NCCL mesh: ``graphable``) the attempts
    run as one captured CUDA graph (module docstring), bitwise the
    host-driven groups."""
    del generator
    dev = resolve_device(device)
    x = local_state(x_init, dev, sharding)
    batch = x.shape[0]
    sharded = sharding is not None and not sharding.replicated
    n_total = x_init.numel()
    f32 = dict(dtype=torch.float32, device=dev)
    span = sde.T - sde.t_eps

    # the tableau's fp32 values and the ends as Python floats: each rounds
    # to the same fp32 scalar in the arithmetic, and a captured attempt
    # holds no tensor made outside its capture
    C, B5, B4 = (a.tolist() for a in (_C, _B5, _B4))
    T, span32, stop32 = (float(torch.tensor(v, dtype=torch.float32))
                         for v in (sde.T, span, span - 1e-12))

    def make_attempt(score_fn):

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

        def attempt(c: OdeCarry) -> OdeCarry:
            x, s, k1 = c.x, c.s, c.k1
            active = (s < stop32) & (c.iterations < max_iters)
            h = torch.minimum(c.h, span32 - s)
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
            scale = c.atol + c.rtol * torch.maximum(torch.abs(x), torch.abs(x5))
            err = torch.sqrt(global_sum_sq((x5 - x4) / scale) / n_total)  # global norm
            accept = (err <= 1.0) & active
            factor = torch.clamp(0.9 * err ** (-0.2), 0.2, 10.0)
            step = active.to(torch.int32)
            s_new = torch.where(accept, s + h, s)
            return dataclasses.replace(
                c, x=torch.where(accept, x5, x), s=s_new, h=torch.where(active, h * factor, h),
                nfe=c.nfe + 6 * step, iterations=c.iterations + step,
                k1=torch.where(accept, ks[6], k1),  # FSAL: k7 is the next k1
                done=~(s_new < stop32).reshape(1))

        return attempt, f

    def host(c: OdeCarry) -> OdeCarry:
        attempt, _ = make_attempt(score_fn)
        running, done_iters = True, 0
        while running and done_iters < max_iters:
            for _ in range(min(SYNC_EVERY, max_iters - done_iters)):
                c = attempt(c)
            flags = torch.stack([(~c.done).to(torch.int32)[0], c.iterations])
            running, done_iters = host_read(flags)  # one host sync
        return c

    def make_horizon(score):
        attempt, _ = make_attempt(score)
        if sharding is None:
            return attempt, attempt  # one attempt a unit; the warm-up is an attempt

        def run(c: OdeCarry) -> OdeCarry:
            for _ in range(SYNC_EVERY):
                c = attempt(c)
            return c

        return run, attempt

    with torch.no_grad():
        _, f = make_attempt(score_fn)
        carry = OdeCarry(
            x=x, s=torch.zeros((), **f32), h=torch.tensor(h_init, **f32),
            nfe=torch.ones((), dtype=torch.int32, device=dev),
            iterations=torch.zeros((), dtype=torch.int32, device=dev),
            k1=f(x, torch.full((), T, **f32)),
            done=torch.zeros((1,), dtype=torch.bool, device=dev),
            rtol=torch.tensor(rtol, **f32), atol=torch.tensor(atol, **f32))
        if graphable(None, noise_fn, sharding, draws=False):
            budget = max(max_iters, 1)
            horizon, horizons = ((budget, 1) if sharding is None
                                 else (1, -(-budget // SYNC_EVERY)))
            carry = solve_cached("ode", sde, (score_fn,), (max_iters,), carry, make_horizon,
                                 max_horizons=horizons, horizon=horizon, max_iters=max_iters,
                                 host=host, sharding=sharding)
        else:
            carry = host(carry)
        x, nfe, iters = carry.x, carry.nfe, carry.iterations
        if denoise:
            x = tweedie_tail(sde, score_fn, x)
            nfe = nfe + 1
    zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return SolveResult(x=x, nfe=nfe.expand(batch).contiguous(), iterations=iters,
                       accepted=zeros, rejected=zeros)
