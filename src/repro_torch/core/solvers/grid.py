"""The fixed-grid baselines' loop (EM, PC, PC-HMC, DDIM): one step of a
``GridCarry`` run ``n_steps`` times, on the host or as one captured CUDA
graph; the counterpart of the reference's ``lax.scan`` over the grid.

The step computes its grid point from the carry's step counter, so the
carry's per-solve values (``n_steps``, the step h and √h, the linspace
ratio r) are buffers and one graph serves every ``n_steps``: EM's
t_i = fma(−i, h, T) with h = (T − t_eps)/n_steps rounded once from a
double to fp32 (``euler_maruyama.em_times``), and the linspace point
(``predictor_corrector.linspace_f32``), each the same bits as the
reference's grid.

``run_grid`` picks the loop. Host-driven: ``n_steps`` calls of the step
and no host read. Graphed (``adaptive.graphable``: no ``noise_fn``, the
noise a ``SlotStreams`` for a solver that draws, and under a mesh on the
card an NCCL mesh): one
window of the cached driver (``adaptive.solve_cached``), whose horizon is
one step and whose condition (P2 on the card) is ``step < n_steps``, so
no step past the grid runs a score evaluation and the window launches
exactly the host-driven run's kernels; one host read a solve. A key's
first solve is host-driven (the one-shot rule). The step is the same
function on both paths, so the graphed solve is the host-driven one bit
for bit.

Under a mesh (``sharding``) each rank steps its rows, and the step
counter, hence the condition, is the same on every rank by construction:
the window needs no flags, and a step adds no collective to the books
(a draw comes from the rank's rows of the streams). Before each solve
the ranks agree on the one-shot rule's branch
(``adaptive.agree_branch``), one all-reduce and one host read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.sde import SDE
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers.base import SlotStreams, fma32

Tensor = torch.Tensor


@dataclasses.dataclass
class GridCarry:
    """State of a fixed-grid solve between steps.

    x: (B, ...) the state. iterations: 0-d int32, the steps taken (the
    grid index of the next step). n_steps: 0-d int32. h, sqrt_h: 0-d fp32,
    EM's step and its root. r: 0-d fp32, the linspace ratio 1/n_steps as
    fp32 rounds it. done: (1,) bool, ``iterations >= n_steps`` (the
    driver's condition, one virtual slot). generator: the noise source
    (``base.draw_noise``: a ``SlotStreams``, or on the host path a
    ``torch.Generator`` or a list of per-slot sources), None for a
    solver that draws nothing.
    """

    x: Tensor
    iterations: Tensor
    n_steps: Tensor
    h: Tensor
    sqrt_h: Tensor
    r: Tensor
    done: Tensor
    generator: Any = None

    @property
    def batch(self) -> int:
        return self.x.shape[0]


def init_grid(sde: SDE, x: Tensor, n_steps: int, generator=None,
              sharding=None) -> GridCarry:
    """The carry at step 0 of an ``n_steps`` grid on ``x``'s device. Under a
    mesh (``sharding``) x holds this rank's rows, and a ``SlotStreams`` of
    the whole batch is cut to them (a row's draws depend on its stream
    alone)."""
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    if isinstance(generator, SlotStreams) and sharding is not None:
        generator = SlotStreams(seed=sharding.local(generator.seed),
                                counter=sharding.local(generator.counter))
    h = torch.tensor((sde.T - sde.t_eps) / n_steps, **f32)
    return GridCarry(
        x=x, iterations=torch.zeros((), dtype=torch.int32, device=dev),
        n_steps=torch.tensor(n_steps, dtype=torch.int32, device=dev), h=h,
        sqrt_h=torch.sqrt(h),
        r=torch.tensor(1.0, **f32) / torch.tensor(float(n_steps), **f32),
        done=torch.full((1,), n_steps <= 0, dtype=torch.bool, device=dev),
        generator=generator)


def ends(sde: SDE) -> tuple:
    """(T, t_eps) rounded to fp32, as Python floats: a step reads them as
    scalars (each rounds to the same fp32 value), so a captured step
    holds no tensor made outside its capture."""
    return tuple(float(torch.tensor(v, dtype=torch.float32)) for v in (sde.T, sde.t_eps))


def em_time(c: GridCarry, T: float) -> Tensor:
    """EM's t_i = T − i·h of step i = ``c.iterations``, 0-d fp32, as
    ``euler_maruyama.em_times`` rounds it (one fused multiply-add: the
    fp64 product of two fp32 values and its sum with T are exact)."""
    f64 = torch.float64
    return (-c.iterations.to(f64) * c.h.to(f64) + T).to(torch.float32)


def linspace_point(c: GridCarry, i: Tensor, a: float, b: float) -> Tensor:
    """Point i (0-d int32) of ``jnp.linspace(a, b, n_steps + 1)`` in fp32,
    0-d, as ``predictor_corrector.linspace_f32`` rounds it: the last point
    is b itself."""
    fi = i.to(torch.float32)
    return torch.where(i == c.n_steps, b, fma32(fi, b * c.r, a * (1 - fi * c.r)))


def advance(c: GridCarry, x: Tensor, draws: int) -> GridCarry:
    """The carry after a step that made ``x`` and took ``draws`` noise
    draws: the step counter and ``done`` move on, and a ``SlotStreams``'s
    counters by ``draws``."""
    gen = c.generator
    if isinstance(gen, SlotStreams) and draws:
        gen = gen.advanced(draws)
    it = c.iterations + 1
    return dataclasses.replace(c, x=x, iterations=it, done=(it >= c.n_steps).reshape(1),
                               generator=gen)


def run_grid(family: str, sde: SDE, score_fn: Callable, carry: GridCarry, n_steps: int,
             make_step: Callable, *, static: tuple = (), graphed: bool,
             sharding=None) -> GridCarry:
    """``n_steps`` steps of ``make_step(score_fn)``, a ``GridCarry -> GridCarry``
    step, from ``carry``: host-driven, or with ``graphed`` one window of the
    cached driver keyed by ``family``, ``sde``, ``score_fn``, ``static``
    (the solver's settings that shape the step), the carry's structure
    and the mesh of ``sharding`` (module docstring)."""

    def host(c: GridCarry) -> GridCarry:
        step = make_step(score_fn)
        for _ in range(n_steps):
            c = step(c)
        return c

    with torch.no_grad():
        if not graphed:
            return host(carry)

        def make_horizon(score):
            step = make_step(score)
            return step, step  # one step a horizon; the warm-up is a step

        return ad.solve_cached(family, sde, (score_fn,), static, carry, make_horizon,
                               max_horizons=ad.UNBOUNDED, host=host, sharding=sharding)
