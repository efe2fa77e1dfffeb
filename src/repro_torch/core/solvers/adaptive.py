"""The paper's adaptive-step reverse-SDE solver (Algorithm 1); port of
``repro/core/solvers/adaptive.py``.

Each sample has its own time t and step size h; the score network sees
the vector of per-sample times, so samples at different t share one
batched forward pass, and finished samples ride along with frozen state
(paper Sec. 3.1.5).

The reference keeps the whole loop on the device in a
``lax.while_loop`` whose condition ``any(t > t_eps)`` is evaluated
there after every iteration. The graphed solves do the same: their
loop is a CUDA-graph WHILE node whose body is one iteration and whose
condition, P2 (``kernels.graph_loop``), evaluates the reference's
condition after each one (below). The host-driven chain, a plain Python
loop, would read that condition back to the host every iteration, so
``solve_chunk`` instead runs ``SYNC_EVERY`` masked iterations between
host syncs and reads one small tensor at each sync. An iteration after
every sample has converged changes nothing (``iterations`` grows by
``any(active)``, so it still equals the reference's count within
``max_iters``), which makes chained chunks bitwise equal to one
monolithic solve, and to the graphed solve, which runs no such
iteration.

The arithmetic after the two score evaluations has two implementations:
``_step_math_jnp`` (plain torch; the name keeps the reference's) and
``_step_math_fused`` (the fused kernel, ``use_fused_kernel=True``).

Noise: by default z is drawn from the carry's ``torch.Generator``. An
optional ``noise_fn(x) -> z`` replaces the draw; tests pass the
reference's own z through it, since JAX's threefry and torch's
generators never give the same numbers. With a projecting conditioner
the iteration draws a second time, after z, for the projection noise
(the order in which the reference splits its key), through the same
seam.

Per-slot noise streams (the reference's (B, 2) per-slot keys,
DESIGN.md §7): the carry's ``generator`` may instead be a
``SlotStreams`` ((B,) seed and counter on the device, drawn by the P1
kernel) or a list of B per-slot sources (callables, the tests' replay
seam), and each sample's row of z then comes from its own stream
(``base.draw_noise``), so a trajectory does not depend on the slot it
occupies or on its seatmates. The body returns the streams' counters
advanced by one draw an iteration in which some sample was active (two
with a projecting conditioner). The serving loop moves a stream with its
row through every compaction permutation.

The device-resident driver (the serve loop, DESIGN.md §12, and every
graphed solve): ``HorizonDriver`` runs a unit of the loop inside a
CUDA-graph WHILE node whose condition is P2, on one set of static carry
buffers, with no host read inside. The unit is one Algorithm-1
iteration (``capture_iteration``), unmasked: P2 runs it only while
``solve_chunk``'s bounds hold (some sample active, fewer than the
horizon's iterations in this horizon, ``iterations < cfg.max_iters``),
and at a horizon's end evaluates ``solve_horizons``' condition on
``events_pending`` (the carry's ``done`` and the occupancy mask;
``kernels.graph_loop.ref``), so a window stops at the iteration where
the reference's nested ``lax.while_loop``s stop and serving events are
still seen at horizon ends only. On the CPU the plain loop
(``kernels.graph_loop.ref.solve_horizons``) runs the same unit and the
same conditions. Under a mesh the unit stays ``capture_horizon``'s
masked group of a horizon's iterations, ended by the mesh's agreement
(``MeshFlags``), one unit a horizon: a condition between two iterations
there would be a collective an iteration.

Telemetry (DESIGN.md §15): ``AdaptiveConfig.telemetry_capacity`` > 0
(or ``init_carry(telemetry=N)``) attaches a ``StepTelemetry`` ring, and
each iteration in which some sample is active writes its per-sample (t,
h, err, accept) there, on the device. Off (the default) the carry has
no ring and the body records nothing; on, recording reads values the
body computed anyway, so the solve's bits are the same either way.

The graphed whole solve (the reference's ``lax.while_loop``): given a
``SlotStreams`` and no ``noise_fn``, and under a mesh on the card an
NCCL mesh (``graphable``, the one rule every solver asks), ``adaptive``
runs its solve through a ``HorizonDriver`` that ``wait_all`` waits on
every row, as the reference's ``adaptive`` is one ``solve_chunk`` of
``max_iters`` iterations: one horizon of at most ``max_iters``
iterations, each its own unit, on the card one WHILE-node graph launch
(P2 its condition, evaluated after every iteration) and one host read a
solve, on the CPU the plain driver over the same iterations. Under a
mesh the unit is the masked ``SYNC_EVERY`` group ended by the mesh's
flags, one a horizon, ⌈``max_iters``/``SYNC_EVERY``⌉ horizons at most.
An iteration with no active sample changes no leaf, so the result is
the host-driven chain's bit for bit, and a graphed solve runs exactly
the iterations the reference runs. The drivers live in one bounded cache
(``cached_driver``) that every graphed family shares (Algorithm 1's,
the fixed-grid baselines' in ``grid.py``, the RK45's, Algorithm 2's),
keyed by structure (``GraphKey``), so a repeated solve copies its fresh
carry, per-solve values included, into the captured buffers and replays
them. Its one-shot rule: a key's first solve runs the host-driven loop
and records the key, the second captures, so a process that solves once
at a key pays no capture. Under a mesh the ranks agree on the rule's
branch before each solve (``agree_branch``), and the horizon of an
Algorithm-1 family ends in the mesh's flags (``MeshFlags``), as the
device-resident serve's does; the fixed grids' and the RK45's conditions
are the same on every rank by construction and need no flags.

``host_syncs`` counts the solvers' device→host reads (``sync_state``'s,
the RK45's and Algorithm 2's group reads, a graphed solve's one read a
window, and under a mesh the branch's agreement: ``host_read``), so the
serving loop and the tables can report the solver's syncs beside their
own.

Conditioning (DESIGN.md §9): ``AdaptiveConfig.conditioner`` is the
static half, ``SolverCarry.cond`` the per-sample payload. The score is
wrapped by the conditioner inside the precision wrap; a projecting
conditioner moves accepted samples only, after the accept decision, and
``x_prev`` stays unprojected. ``finalize`` denoises with the conditioned
field and then applies ``finalize_project``.

Precision (DESIGN.md §8): x / x_prev live in the policy's state dtype;
t, h, the tolerance, the error, the accept decision and the step-size
update are fp32 under every preset.

Sharding (DESIGN.md §3): under a mesh the solve is data-parallel over
``torch.distributed``. ``sharding`` is the batch sharding of the state
(``repro_torch.parallel.sharding.sample_state_shardings``); ``init_carry``
takes the global (B, ...) start and keeps this rank's rows of every
per-sample leaf (``solver_carry_shardings``: per-slot streams and the
telemetry ring's rows too), a shared generator's draw is the whole
batch's draw cut to those rows, per-slot streams draw the rank's rows
directly, and the fused step runs K4 (``sharded_error_step``) on them.
Loop control stays global: at each group's sync one ``all_reduce(MAX)``
of [any sample active, iterations] over the mesh gives every rank the
reference's ``any(t > t_eps)`` and its iteration count. Because
``active`` only falls within a group, the iterations in which a rank had
an active sample form a prefix of the group, and the largest such count
over the ranks is the count of iterations in which some sample anywhere
was active. A rank whose samples are all done keeps running masked
iterations until every rank's are, as the reference's while loop does.
A rank whose prefix was shorter than the mesh's then catches up
(``_catch_up``): the unsharded body would have recorded its frozen rows
in the telemetry ring (t, h = 0, err = 0, no accept) and moved their
stream counters in the iterations it skipped, and the catch-up does
exactly that, so the ring and the streams are the unsharded carry's
rows. One O(1) collective per group of ``SYNC_EVERY`` iterations, no
host sync per iteration. Everything but the score network runs row by
row, so the sharded solve gives the unsharded solve's bits wherever the
score of a row does not depend on the batch around it (the closed-form
scores; a network on this CPU; cuBLAS may round a product of fewer rows
otherwise).

The device-resident driver under a mesh (``MeshFlags``): after every
horizon the ranks agree on the event flags (an occupied sample running,
an occupied sample done) and the iteration count with one
``all_reduce(MAX)`` of three int32, so every rank runs the same number
of horizons, as the reference's ``lax.while_loop`` over the whole batch
does. On the card that all-reduce is an NCCL collective captured into
the horizon's graph, inside the WHILE node's body ahead of P2, which
then reads the agreed flags as a batch of two virtual slots; gloo
collectives cannot be captured, so a device-resident server on CUDA
tensors over gloo raises. On the CPU the plain driver all-reduces over
gloo after every horizon. A graphed solve under a mesh (``sample(mesh=)``,
every solver's ``sharding``) runs through the same flags; on a gloo mesh
on the card it stays host-driven (``graphable``).

Algorithm 2 (``adaptive_forward``, paper App. C) is at the end: the
forward-time solver for a general diffusion with x-dependent g, graphed
as Algorithm 1 is on per-row streams.

The solver zoo's two families (DESIGN.md §11) are this body with one
field set. ``AdaptiveConfig.momentum`` = β adds β·v, v = x − x_prev the
last accepted displacement, to both proposals (the fused step takes
x + β·v as its x), and x_prev then holds the last accepted state, so v
is 0 at ``init_carry`` and at a server's admission, where x_prev = x =
the prior. ``AdaptiveConfig.probability_flow`` integrates the
probability-flow ODE: the score coefficients halve, the noise
coefficients are 0, z is zeros and the main draw is skipped, so a
stream's counter moves only for a projecting conditioner's draw
(``momentum.py``, ``heun.py``).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import gc
import inspect
import time
import weakref
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.guidance import Conditioner, cond_batch
from repro_torch.core.precision import PrecisionPolicy, resolve_policy
from repro_torch.core.sde import SDE, bcast
from repro_torch.core.solvers.base import (
    SlotStreams, SolveResult, check_noise_source, draw_noise, register_solver,
)
from repro_torch.core.tolerance import (
    mixed_tolerance, next_step_size, scaled_error_l2, scaled_error_linf,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.graph_loop import ops as loop_ops
from repro_torch.kernels.graph_loop import ref as loop_ref
from repro_torch.kernels.graph_loop.ref import events_pending  # noqa: F401  (the reference's name)
from repro_torch.observability.telemetry import (
    StepTelemetry, init_telemetry, record_step,
)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.collectives import all_max

Tensor = torch.Tensor

#: masked iterations the host-driven ``solve_chunk`` runs between two host
#: syncs, and the masked group a graphed horizon under a mesh captures. At
#: most SYNC_EVERY − 1 of them run after the last sample converged, and
#: those change nothing. A graphed solve without a mesh runs none of them.
SYNC_EVERY = 8

#: a driver's bound that never binds: the ``max_horizons`` of a window its
#: ``done`` alone ends (a fixed grid's, whose ``done`` rises after its last
#: step), the ``max_iters`` of a loop without an iteration budget
UNBOUNDED = 2 ** 31 - 1

#: ``sync_state`` device→host reads since the count was last set to 0
host_syncs = 0

#: the solvers that run this body and take its configuration (eps_rel,
#: max_iters, the fused step, precision): ``adaptive``, ``momentum.py``,
#: ``heun.py``
ADAPTIVE_FAMILY = ("adaptive", "momentum", "heun")


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Hyper-parameters of Algorithm 1 (defaults = paper defaults)."""

    eps_rel: float = 0.01
    eps_abs: Optional[float] = None  # None → sde.abs_tolerance
    h_init: float = 0.01
    safety: float = 0.9  # θ
    r_exponent: float = 0.9  # r
    error_norm: str = "l2"  # "l2" (paper) | "linf" (ablation)
    prev_tolerance: bool = True  # δ(x', x'_prev) (Eq. 5) vs δ(x') (Eq. 4)
    extrapolate: bool = True  # accept x'' (paper) vs x' (ablation)
    max_iters: int = 100_000
    use_fused_kernel: bool = False
    #: precision preset name or PrecisionPolicy (DESIGN.md §8)
    precision: "str | PrecisionPolicy" = "fp32"
    #: static half of a score-field conditioner (DESIGN.md §9); None is
    #: the unconditional path
    conditioner: Optional[Conditioner] = None
    #: heavy-ball coefficient β of the ``momentum`` family (DESIGN.md
    #: §11): both proposals gain β·(x − x_prev), and x_prev holds the last
    #: accepted state instead of the last accepted x'; 0.0 is Algorithm 1
    momentum: float = 0.0
    #: integrate the probability-flow ODE (the ``heun`` family, DESIGN.md
    #: §11): halved score coefficients, no noise, no main draw
    probability_flow: bool = False
    #: step-telemetry ring capacity (DESIGN.md §15): > 0 makes
    #: ``init_carry`` attach a ``StepTelemetry`` ring of that many records
    #: a sample; 0 leaves the carry without one
    telemetry_capacity: int = 0


def resolve_config(config: Optional[AdaptiveConfig], overrides) -> AdaptiveConfig:
    """Merge an optional AdaptiveConfig with keyword overrides."""
    if config is None:
        return AdaptiveConfig(**overrides)
    return dataclasses.replace(config, **overrides) if overrides else config


def _step_math_jnp(x, x_prime, score2, z, x_prev, e0, d1, d2, cfg,
                   eps_abs, eps_rel):
    """x̃, x'' and the scaled error in plain torch, fp32 throughout.

    e0 = h·a(t−h); d1 = h·g(t−h)²; d2 = √h·g(t−h); all (B,).
    x̃  = x − e0·x' + d1·score2 + d2·z;  x'' = ½ (x' + x̃).
    ``eps_abs``/``eps_rel`` are floats or (B,) fp32 tensors. Returns
    (x'' fp32, err fp32 (B,)).
    """
    x, x_prime, score2, z, x_prev = (
        a.to(torch.float32) for a in (x, x_prime, score2, z, x_prev))
    if isinstance(eps_abs, Tensor):
        eps_abs = bcast(eps_abs, x)
    if isinstance(eps_rel, Tensor):
        eps_rel = bcast(eps_rel, x)
    x_tilde = (x - bcast(e0, x) * x_prime + bcast(d1, x) * score2
               + bcast(d2, x) * z)
    x_high = 0.5 * (x_prime + x_tilde)
    delta = mixed_tolerance(x_prime, x_prev if cfg.prev_tolerance else None,
                            eps_abs, eps_rel)
    if cfg.error_norm == "l2":
        err = scaled_error_l2(x_prime, x_high, delta)
    elif cfg.error_norm == "linf":
        err = scaled_error_linf(x_prime, x_high, delta)
    else:
        raise ValueError(f"unknown error_norm {cfg.error_norm!r}")
    return x_high, err


def _step_math_fused(x, x_prime, score2, z, x_prev, e0, d1, d2, cfg,
                     eps_abs, eps_rel):
    """The fused solver-step kernel: operands stay in the state dtype, x''
    comes back in it, the error is fp32. Scalar and per-sample (B,)
    tolerances take the same kernel."""
    from repro_torch.kernels.solver_step import ops as fused

    if cfg.error_norm != "l2":
        raise ValueError("the fused kernel implements the paper's ℓ2 norm only")
    return fused.error_step(x, x_prime, score2, z, x_prev, e0, d1, d2,
                            eps_abs=eps_abs, eps_rel=eps_rel,
                            use_prev=cfg.prev_tolerance)


def _step_math_fused_sharded(x, x_prime, score2, z, x_prev, e0, d1, d2, cfg,
                             eps_abs, eps_rel, *, sharding):
    """The fused step under a batch-sharded mesh: K4 on this rank's rows
    (DESIGN.md §3)."""
    from repro_torch.kernels.solver_step import ops as fused

    if cfg.error_norm != "l2":
        raise ValueError("the fused kernel implements the paper's ℓ2 norm only")
    return fused.sharded_error_step(
        x, x_prime, score2, z, x_prev, e0, d1, d2, eps_abs=eps_abs,
        eps_rel=eps_rel, use_prev=cfg.prev_tolerance, mesh=sharding.mesh,
        batch_axes=sharding.axes)


@dataclasses.dataclass
class SolverCarry:
    """State of an Algorithm-1 solve between iterations.

    x, x_prev: state and last accepted low-order proposal (B, ...), in
    the policy's state dtype. t, h: per-sample time and step (B,) fp32.
    nfe / accepted / rejected: (B,) int32. done: (B,) bool, t <= t_eps.
    iterations: 0-d int32, iterations in which some sample was active.
    generator: the noise source of the default draw, a ``torch.Generator``
    shared by the batch, a ``SlotStreams`` or a list of B per-slot
    sources (``draw_noise``).
    atol / rtol: optional per-sample tolerances (B,) fp32 that replace the
    config's (DESIGN.md §14); both or neither. cond: the conditioner's
    per-sample payload (DESIGN.md §9), a dict of tensors leading with B,
    or None. telemetry: the optional ``StepTelemetry`` ring (DESIGN.md
    §15), None when off.
    """

    x: Tensor
    x_prev: Tensor
    t: Tensor
    h: Tensor
    nfe: Tensor
    accepted: Tensor
    rejected: Tensor
    done: Tensor
    iterations: Tensor
    generator: Any = None
    atol: Optional[Tensor] = None
    rtol: Optional[Tensor] = None
    cond: Optional[dict] = None
    telemetry: Optional[StepTelemetry] = None

    @property
    def batch(self) -> int:
        return self.x.shape[0]


def _eps_abs(sde: SDE, cfg: AdaptiveConfig) -> float:
    """The absolute tolerance of ``cfg`` (None: the SDE's)."""
    return float(sde.abs_tolerance if cfg.eps_abs is None else cfg.eps_abs)


def _per_sample(v, batch: int, device) -> Tensor:
    v = torch.as_tensor(v, dtype=torch.float32).to(device)
    return v.expand(batch).contiguous()


def init_carry(sde: SDE, x_init: Tensor, generator, *,
               config: AdaptiveConfig | None = None, cond=None, atol=None,
               rtol=None, h0=None, sharding=None, telemetry=None,
               **overrides) -> SolverCarry:
    """Fresh carry at t = T on ``x_init``'s device.

    ``generator`` is a ``torch.Generator`` shared by the batch, or per-slot
    streams: a ``SlotStreams`` of B rows (as the reference's ``init_carry``
    takes a (B, 2) key; a batch-1 solve from ``SlotStreams.of([seed], 1)``
    on the prior at counter 0 is a served request's stream discipline) or
    a list of B sources. ``cond`` is the optional per-sample condition
    payload: every leaf must lead with the batch dimension; it moves to
    x's device, and its float leaves become fp32 (projection and guidance
    are control-path math). ``atol``/``rtol`` (scalars or (B,)) install per-sample
    tolerances; pass both or neither. ``h0`` overrides the initial step
    per sample; it is clamped to the t-span like ``cfg.h_init``.
    ``telemetry`` overrides ``cfg.telemetry_capacity``: a positive
    capacity attaches a fresh ring, 0 forces it off, None defers to the
    config.

    With ``sharding`` (the state's batch sharding under a mesh) every
    argument is global, and the carry holds this rank's rows of each
    per-sample leaf (``solver_carry_shardings``): per-slot streams (a
    ``SlotStreams`` or a list of sources) and the telemetry ring's rows
    included.
    """
    cfg = resolve_config(config, overrides)
    policy = resolve_policy(cfg.precision)
    x_init = x_init.to(policy.state)
    batch, dev = x_init.shape[0], x_init.device
    if (atol is None) != (rtol is None):
        raise ValueError("per-sample tolerances come in pairs: pass both "
                         "atol and rtol, or neither")
    if isinstance(generator, SlotStreams) and generator.seed.shape != (batch,):
        raise ValueError(f"{generator.seed.shape[0]} streams for a batch of {batch}")
    if atol is not None:
        atol, rtol = _per_sample(atol, batch, dev), _per_sample(rtol, batch, dev)
    if cond is not None:
        cb = cond_batch(cond)
        if cb is not None and cb != batch:
            raise ValueError(f"condition payload batch {cb} != state batch {batch}")
        cond = {k: v.to(device=dev, dtype=torch.float32)
                if v.dtype.is_floating_point else v.to(dev)
                for k, v in cond.items()}
    t0 = torch.full((batch,), sde.T, dtype=torch.float32, device=dev)
    h_of = cfg.h_init if h0 is None else h0
    h = torch.minimum(_per_sample(h_of, batch, dev), t0 - sde.t_eps)
    zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
    cap = int(cfg.telemetry_capacity if telemetry is None else telemetry)
    carry = SolverCarry(
        x=x_init, x_prev=x_init, t=t0, h=h, nfe=zeros, accepted=zeros,
        rejected=zeros, done=torch.zeros((batch,), dtype=torch.bool, device=dev),
        iterations=torch.zeros((), dtype=torch.int32, device=dev),
        generator=generator, atol=atol, rtol=rtol, cond=cond,
        telemetry=init_telemetry(batch, cap, dev) if cap > 0 else None)
    return carry if sharding is None else _local_rows(carry, sharding)


def _local_rows(carry: SolverCarry, sharding) -> SolverCarry:
    """This rank's rows of every per-sample leaf of a global carry."""
    from repro_torch.parallel.sharding import solver_carry_shardings

    if carry.batch != sharding.batch:
        raise ValueError(f"state batch {carry.batch} != sharding batch {sharding.batch}")
    gen = carry.generator
    shards = solver_carry_shardings(
        sharding.mesh, carry.batch, carry.x.ndim,
        per_slot_keys=isinstance(gen, (SlotStreams, list)), cond=carry.cond,
        tolerances=carry.atol is not None, telemetry=carry.telemetry is not None)
    leaves = {}
    for f in dataclasses.fields(carry):
        v, s = getattr(carry, f.name), getattr(shards, f.name)
        if v is None or s is None or (isinstance(s, type(sharding)) and s.batch is None):
            pass
        elif f.name == "cond":
            v = {k: s[k].local(leaf) for k, leaf in v.items()}
        elif f.name == "telemetry":
            v = StepTelemetry(**{g.name: getattr(v, g.name) if g.name == "head"
                                 else getattr(s, g.name).local(getattr(v, g.name))
                                 for g in dataclasses.fields(v)})
        elif isinstance(v, SlotStreams):
            v = SlotStreams(seed=s.local(v.seed), counter=s.local(v.counter))
        elif isinstance(v, list):
            v = v[s.rows]
        elif isinstance(v, Tensor):
            v = s.local(v)
        leaves[f.name] = v
    return SolverCarry(**leaves)


def draws_per_iteration(cfg: AdaptiveConfig) -> int:
    """Noise draws one active iteration of the body makes: z (none on the
    probability-flow ODE), then a projecting conditioner's."""
    projecting = cfg.conditioner is not None and cfg.conditioner.has_projection
    return (0 if cfg.probability_flow else 1) + (1 if projecting else 0)


def _catch_up(carry: SolverCarry, lag, max_lag: int, draws: int) -> SolverCarry:
    """A rank's carry after ``lag`` iterations in which none of its samples
    was active but some sample on another rank was: what the unsharded
    body records for frozen rows in such an iteration (t at entry, h 0,
    err 0, no accept) goes into the telemetry ring, and the per-slot
    stream counters move on by ``lag · draws``. ``lag`` is a Python int
    (then ``max_lag`` is it) or a 0-d int32 tensor of at most ``max_lag``
    (masked writes, no host read: the captured horizon's form)."""
    tel, gen = carry.telemetry, carry.generator
    if tel is not None and max_lag:
        zero = torch.zeros_like(carry.t)
        no = torch.zeros_like(carry.done)
        for k in range(max_lag):
            live = (torch.ones((), dtype=torch.bool, device=carry.t.device)
                    if isinstance(lag, int) else lag > k)
            tel = record_step(tel, t=carry.t, h=zero, err=zero, accept=no, live=live)
    if isinstance(gen, SlotStreams) and draws:
        gen = gen.advanced(lag * draws)
    return dataclasses.replace(carry, telemetry=tel, generator=gen)


def _make_body(sde: SDE, score_fn, cfg: AdaptiveConfig, eps_abs: float,
               step_math, noise_fn=None, sharding=None):
    """One Algorithm-1 iteration: ``body(carry, limits=None) -> carry``.

    The conditioner wraps the raw ``score_fn`` innermost (a label-aware
    score sees real labels), the precision policy's casts outermost.
    Under a mesh (``sharding``) the carry holds this rank's rows and each
    draw is the whole batch's, cut to them.

    ``limits = (start, horizon)`` puts ``solve_chunk``'s host-side bounds
    into the mask on the device (the graphed horizon): a sample is active
    only while ``iterations − start < horizon`` and ``iterations <
    cfg.max_iters``, ``start`` a 0-d int32 tensor. An iteration in which
    no sample is active changes no leaf, the stream counters included.
    """
    policy = resolve_policy(cfg.precision)
    conditioner = cfg.conditioner
    projecting = conditioner is not None and conditioner.has_projection
    threshold = sde.t_eps + 1e-12
    mom = float(cfg.momentum)
    pf = bool(cfg.probability_flow)
    draws = draws_per_iteration(cfg)

    def draw(s: SolverCarry, x: Tensor, offset: int) -> Tensor:
        return draw_noise(s.generator, noise_fn, x, sharding, offset)

    def em_coeffs(t: Tensor, h: Tensor):
        """x' = c0·x + c1·score + c2·z; the probability-flow ODE halves the
        score's coefficient and has no noise."""
        a, g = sde.drift_coeff(t), sde.diffusion(t)
        if pf:
            return 1.0 - h * a, 0.5 * h * g * g, torch.zeros_like(h)
        return 1.0 - h * a, h * g * g, torch.sqrt(h) * g

    def body(s: SolverCarry, limits=None) -> SolverCarry:
        x, x_prev, t, h = s.x, s.x_prev, s.t, s.h
        sf = score_fn
        if conditioner is not None:
            sf = conditioner.wrap_score(sf, s.cond)
        sf = policy.wrap_score_fn(sf)
        active = t > threshold
        if limits is not None:
            start, horizon = limits
            active = active & ((s.iterations - start < horizon)
                               & (s.iterations < cfg.max_iters))
        # frozen samples are fed clamped times
        t_c = torch.clamp(t, sde.t_eps, sde.T)
        h_c = torch.where(active, h, 0.0)
        t2 = torch.clamp(t_c - h_c, sde.t_eps, sde.T)
        # the probability-flow ODE draws no z (its stream does not move)
        z = torch.zeros_like(x) if pf else draw(s, x, 0)
        if projecting:
            # the projection's own draw, after z: the unconditional
            # noise stream is untouched by the conditioning seam
            z_proj = draw(s, x, draws - 1)

        # low-order proposal: one reverse Euler–Maruyama step. The fp32
        # coefficients promote the arithmetic to fp32; x' is stored back
        # at the state dtype.
        score1 = sf(x, t_c)
        c0, c1, c2 = em_coeffs(t_c, h_c)
        x_base = x
        x_prime = bcast(c0, x) * x + bcast(c1, x) * score1 + bcast(c2, x) * z
        if mom:
            # heavy-ball transport shared by both proposals, so the error
            # estimate still measures the EM / Improved-Euler gap only
            v = x.to(torch.float32) - x_prev.to(torch.float32)
            x_base = (x.to(torch.float32) + mom * v).to(x.dtype)
            x_prime = x_prime + mom * v
        x_prime = x_prime.to(x.dtype)

        # high-order proposal: stochastic Improved Euler (Heun's
        # trapezoid on the probability-flow ODE)
        score2 = sf(x_prime, t2)
        e0 = h_c * sde.drift_coeff(t2)
        g2 = sde.diffusion(t2)
        d1 = (0.5 * h_c if pf else h_c) * g2 * g2
        d2 = torch.zeros_like(h_c) if pf else torch.sqrt(h_c) * g2
        ea = eps_abs if s.atol is None else s.atol
        er = cfg.eps_rel if s.rtol is None else s.rtol
        x_high, err = step_math(x_base, x_prime, score2, z, x_prev, e0, d1, d2,
                                cfg, ea, er)
        proposal = (x_high if cfg.extrapolate else x_prime).to(x.dtype)

        accept = (err <= 1.0) & active
        acc_e = bcast(accept, x)
        t_new = torch.where(accept, t - h, t)
        x_new = torch.where(acc_e, proposal, x)
        if projecting:
            # post-accept projection at each sample's new t, fp32; only
            # accepted samples move, and x_prev stays unprojected
            projected = conditioner.project(sde, x_new, t_new, s.cond, z_proj)
            x_new = torch.where(acc_e, projected.to(x.dtype), x_new)
        remaining = torch.clamp(t_new - sde.t_eps, min=0.0)
        h_new = next_step_size(h, err, remaining, safety=cfg.safety,
                               r_exponent=cfg.r_exponent)
        any_active = active.any()
        tel = s.telemetry
        if tel is not None:
            # the attempted step: entry t, the active-clamped h, the fp32
            # error and the accept bit; a masked iteration records nothing
            tel = record_step(tel, t=t, h=h_c, err=err, accept=accept,
                              live=any_active)
        two = torch.where(active, 2, 0).to(torch.int32)
        gen = s.generator
        if isinstance(gen, SlotStreams) and draws:
            gen = gen.advanced(any_active.to(torch.int64) * draws)
        return SolverCarry(
            x=x_new,
            # the momentum family keeps the last accepted state (v = x −
            # x_prev); otherwise the last accepted x' (Eq. 5)
            x_prev=torch.where(acc_e, x if mom else x_prime, x_prev),
            t=t_new,
            h=torch.where(active, h_new, h),
            nfe=s.nfe + two,
            accepted=s.accepted + accept.to(torch.int32),
            rejected=s.rejected + (~accept & active).to(torch.int32),
            done=t_new <= threshold,
            iterations=s.iterations + any_active.to(torch.int32),
            generator=gen, atol=s.atol, rtol=s.rtol, cond=s.cond,
            telemetry=tel)

    return body


def sync_state(carry: SolverCarry, sharding=None):
    """(every sample done, iterations) as Python values: one device→host
    transfer.

    Under a mesh (``sharding``) both are global: one ``all_reduce(MAX)``
    of [some sample active, iterations] over the whole mesh. A carry's
    ``iterations`` counts the iterations in which one of its own samples
    was active; after a group that all ranks began at the same count, the
    largest of those counts is the global one (see the module docstring).
    """
    done, iters, _ = _sync(carry, sharding)
    return done, iters


def _sync(carry: SolverCarry, sharding):
    """``sync_state`` plus this rank's own iteration count, read in the same
    transfer."""
    vals = host_read(sync_flags(carry, sharding))
    return not vals[0], int(vals[1]), int(vals[-1])


def sync_flags(carry: SolverCarry, sharding=None) -> Tensor:
    """[some sample active, iterations] on the device, made global under a
    mesh by one ``all_reduce(MAX)`` (the loop control of a sync group),
    with this rank's own iterations appended there: what ``_sync`` reads."""
    flags = torch.stack([(~carry.done).any().to(torch.int32), carry.iterations])
    if sharding is not None:
        flags = torch.cat([flags, carry.iterations.reshape(1)])
        all_max(flags[:2], sharding.mesh)
    return flags


def _pick_step_math(cfg: AdaptiveConfig, sharding):
    if not cfg.use_fused_kernel:
        return _step_math_jnp
    if sharding is not None and not sharding.replicated:
        return functools.partial(_step_math_fused_sharded, sharding=sharding)
    return _step_math_fused


def solve_chunk(sde: SDE, score_fn: Callable, carry: SolverCarry, *,
                max_sync_iters: int, config: AdaptiveConfig | None = None,
                noise_fn: Callable | None = None, sharding=None,
                **overrides) -> SolverCarry:
    """Run at most ``max_sync_iters`` Algorithm-1 iterations.

    Stops early when every sample has converged or the solve's
    ``cfg.max_iters`` budget is spent. Iterations run in groups of at
    most ``SYNC_EVERY``, sized so that neither bound can be overrun, with
    one host sync after each group. Chaining calls until ``done.all()``
    is bitwise equal to one call with an unbounded ``max_sync_iters``.
    Under a mesh (``sharding``) the sync is global and the carry's
    ``iterations`` is set to the global count after each group, so every
    rank runs the same groups; a rank that idled through the end of a
    group catches up (``_catch_up``).
    """
    cfg = resolve_config(config, overrides)
    body = _make_body(sde, score_fn, cfg, _eps_abs(sde, cfg), _pick_step_math(cfg, sharding),
                      noise_fn, sharding)
    done, iters = sync_state(carry, sharding)
    start = iters
    with torch.no_grad():
        while not done and iters - start < max_sync_iters and iters < cfg.max_iters:
            n = min(SYNC_EVERY, max_sync_iters - (iters - start),
                    cfg.max_iters - iters)
            for _ in range(n):
                carry = body(carry)
            done, iters, local = _sync(carry, sharding)
            if sharding is not None:
                if iters > local:
                    carry = _catch_up(carry, iters - local, iters - local,
                                      draws_per_iteration(cfg))
                carry.iterations = torch.full((), iters, dtype=torch.int32,
                                              device=carry.iterations.device)
    return carry


def _tensor_leaves(v) -> list:
    """Every tensor of a carry (or of one of its leaves), in field order;
    a list of per-slot sources holds none."""
    if isinstance(v, Tensor):
        return [v]
    if isinstance(v, dict):
        return [t for k in sorted(v) for t in _tensor_leaves(v[k])]
    if dataclasses.is_dataclass(v):
        return [t for f in dataclasses.fields(v) for t in _tensor_leaves(getattr(v, f.name))]
    return []


def own_buffers(carry: SolverCarry) -> SolverCarry:
    """Give every tensor leaf of ``carry`` a buffer of its own, in place:
    a leaf that shares another's memory (``init_carry`` starts x_prev as
    x and the three counters as one zeros) is replaced by a copy. A
    carry that is written in place, leaf by leaf, needs this."""
    seen = set()

    def fix(v):
        if isinstance(v, Tensor):
            if v.data_ptr() in seen:
                v = v.clone()
            seen.add(v.data_ptr())
            return v
        if isinstance(v, dict):
            return {k: fix(v[k]) for k in sorted(v)}
        if dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                setattr(v, f.name, fix(getattr(v, f.name)))
        return v

    return fix(carry)


def copy_carry_(dst: SolverCarry, src: SolverCarry) -> None:
    """Write ``src``'s leaves into ``dst``'s buffers (leaves ``src`` shares
    with ``dst`` are left alone): the last nodes of a captured horizon,
    and the plain driver's copy-back."""
    for a, b in zip(_tensor_leaves(dst), _tensor_leaves(src), strict=True):
        if a is not b:
            a.copy_(b)


def capture_graph(carry, run: Callable, warm: Callable) -> torch.cuda.CUDAGraph:
    """Record ``run(carry) -> carry`` as one CUDA graph over ``carry``'s
    buffers (``keep_graph=True``: the raw graph is kept for a parent graph
    to hold, ``kernels.graph_loop``); its last nodes ``copy_`` the new
    leaves into ``carry``'s buffers (``copy_carry_``). Lazy library state
    (cuBLAS handles, kernel attributes, NCCL communicators and any
    subgroup ``collectives.axes_group`` makes) is made first by ``warm``
    on a copy of the carry, on a side stream (one iteration of the loop
    ``run`` unrolls: its launches and collectives are real and counted),
    so that nothing of the kind is made inside the graph. ``carry`` must
    own its buffers (``own_buffers``) and keep them, and ``run`` may read
    no tensor it did not make under the capture besides the carry's (the
    graph keeps neither ``run`` nor what it closes over, so that a cached
    graph holds no score function). ``graph.recorded``
    is {(wrapper module, its launch counter): its kernel calls in the
    graph} (``graph_loop.ops.captured_calls``) and ``graph.books`` its
    collectives (``collectives.captured_since``): what one replay
    launches and runs, which the driver charges to the wrappers' launch
    counts and to the collectives' books."""
    dev = carry.x.device
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.no_grad():
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm(copy.deepcopy(carry))
        torch.cuda.current_stream(dev).wait_stream(side)
        before, books = loop_ops.captured_calls(), coll.captured_books()
        with torch.cuda.graph(graph):
            copy_carry_(carry, run(carry))
    graph.recorded = {k: n - before[k] for k, n in loop_ops.captured_calls().items()}
    graph.books = coll.captured_since(books)
    return graph


def capture_iteration(sde: SDE, score_fn: Callable, carry: SolverCarry, *,
                      config: AdaptiveConfig | None = None,
                      **overrides) -> torch.cuda.CUDAGraph:
    """Record one unmasked Algorithm-1 iteration as a CUDA graph over
    ``carry``'s buffers (``capture_graph``): the unit of an unsharded
    device-resident driver, which replays it only while ``solve_chunk``'s
    condition holds, so no iteration runs after the last sample converged.
    ``carry`` must own its buffers (``own_buffers``) and keep them, and its
    noise must come from a ``SlotStreams`` (``capture_horizon``). The
    warm-up is one body iteration."""
    cfg = resolve_config(config, overrides)
    if not isinstance(carry.generator, SlotStreams):
        raise ValueError("a captured iteration draws its noise from SlotStreams: a CUDA "
                         "graph cannot call per-slot Python sources or a generator")
    return capture_graph(carry, *_iteration(sde, score_fn, cfg))


def _iteration(sde: SDE, score_fn: Callable, cfg: AdaptiveConfig) -> tuple:
    """(run, warm) of ``capture_iteration``: both one unmasked body
    iteration (on the CPU ``run`` is the plain driver's unit)."""
    body = _make_body(sde, score_fn, cfg, _eps_abs(sde, cfg), _pick_step_math(cfg, None))
    return body, body


def capture_horizon(sde: SDE, score_fn: Callable, carry: SolverCarry, *,
                    sync_horizon: int, config: AdaptiveConfig | None = None,
                    sharding=None, flags: Optional["MeshFlags"] = None,
                    **overrides) -> torch.cuda.CUDAGraph:
    """Record ``sync_horizon`` masked Algorithm-1 iterations as one CUDA
    graph over ``carry``'s buffers (``capture_graph``): the unit of a
    device-resident driver under a mesh, one a horizon, whose iterations
    cannot each end in a condition without a collective each.

    The graph copies ``carry.iterations`` into its own ``start`` first and
    runs each iteration under ``limits=(start, sync_horizon)``, so the
    bounds ``solve_chunk`` checks on the host are part of the mask and the
    graph reads nothing back. A replay is therefore one ``solve_chunk(...,
    max_sync_iters=sync_horizon)`` on the carry, bit for bit where the
    same kernels run (an iteration past the bounds changes nothing, but
    runs its score evaluations).
    ``carry`` must own its buffers (``own_buffers``) and keep them: the
    caller writes new requests into them in place. Its noise must come
    from a ``SlotStreams``: a graph cannot call Python sources, and a
    shared generator's state would be frozen into it. The warm-up is one
    body iteration.

    Under a mesh the carry holds this rank's rows of ``sharding`` (the
    fused step is K4's), and ``flags`` (``MeshFlags``) appends the mesh's
    agreement to the graph: an NCCL all-reduce of the event flags and the
    iteration count, and the catch-up of a rank that idled.
    """
    cfg = resolve_config(config, overrides)
    if not isinstance(carry.generator, SlotStreams):
        raise ValueError("a captured horizon draws its noise from SlotStreams: a CUDA "
                         "graph cannot call per-slot Python sources or a generator")
    run, warm = _horizon(sde, score_fn, cfg, sync_horizon, sharding)
    return capture_graph(carry, run if flags is None else _then_update(run, flags), warm)


def _horizon(sde: SDE, score_fn: Callable, cfg: AdaptiveConfig, sync_horizon: int,
             sharding=None) -> tuple:
    """(run, warm) of ``capture_horizon``: ``run`` copies the carry's
    iterations into its own ``start`` (made under the capture, in the
    graph's pool) and runs ``sync_horizon`` masked iterations, in place;
    ``warm`` one body iteration."""
    body = _make_body(sde, score_fn, cfg, _eps_abs(sde, cfg), _pick_step_math(cfg, sharding),
                      sharding=sharding)

    def run(c: SolverCarry) -> SolverCarry:
        limits = (c.iterations.clone(), int(sync_horizon))
        out = c
        for _ in range(int(sync_horizon)):
            out = body(out, limits)
        copy_carry_(c, out)
        return c

    return run, lambda c: body(c, (c.iterations.clone(), int(sync_horizon)))


def mesh_capturable(group) -> bool:
    """Whether collectives over ``group`` can be captured into a CUDA graph:
    NCCL's can, gloo's cannot."""
    return dist.get_backend(group) == "nccl"


class MeshFlags:
    """The serving event flags of a sharded carry, agreed on by the mesh
    after every horizon (DESIGN.md §12).

    ``update(carry)`` computes this rank's [an occupied sample running,
    an occupied sample done, iterations] into a (3,) int32 buffer,
    all-reduces it with MAX over the mesh, writes the result as a batch
    of two virtual slots (``occupied_v`` = [running, done-and-occupied],
    ``done_v`` = [False, True], on which P2 and ``events_pending`` give
    the whole mesh's flag) and brings the carry to the agreed iteration
    count (``_catch_up``, at most ``horizon`` iterations behind). It reads
    nothing back, so a CUDA graph can capture it: with NCCL the
    all-reduce is a captured collective. ``draws`` is the body's draws an
    iteration (``draws_per_iteration``).
    """

    def __init__(self, sharding, occupied: Tensor, *, horizon: int, draws: int):
        dev = occupied.device
        self.sharding = sharding
        self.group = sharding.mesh.group()
        self.occupied = occupied
        self.horizon, self.draws = int(horizon), int(draws)
        self.buf = torch.zeros(3, dtype=torch.int32, device=dev)
        self.occupied_v = torch.zeros(2, dtype=torch.bool, device=dev)
        self.done_v = torch.tensor([False, True], device=dev)

    def update(self, carry: SolverCarry) -> None:
        occ, done = self.occupied, carry.done
        self.buf.copy_(torch.stack([(occ & ~done).any().to(torch.int32),
                                    (occ & done).any().to(torch.int32),
                                    carry.iterations]))
        all_max(self.buf, self.group)
        self.occupied_v.copy_(self.buf[:2] > 0)
        lag = self.buf[2] - carry.iterations
        if carry.x.device.type == "cpu":  # the plain driver: the lag is free to read
            lag = int(lag)
            if not lag:
                return
            caught = _catch_up(carry, lag, lag, self.draws)
        else:
            caught = _catch_up(carry, lag, self.horizon, self.draws)
        copy_carry_(carry, dataclasses.replace(caught, iterations=self.buf[2]))

    def masks(self, carry: SolverCarry):
        """``update``, then the virtual (occupied, done) pair: the plain
        driver's condition."""
        self.update(carry)
        return self.occupied_v, self.done_v


def horizon_unit(sde: SDE, score_fn: Callable, cfg: AdaptiveConfig, *, sync_horizon: int,
                 device, sharding=None, flags: Optional["MeshFlags"] = None) -> tuple:
    """(unit, horizon): the unit of a device-resident Algorithm-1 driver
    (``HorizonDriver``'s) and the units a ``sync_horizon`` horizon holds.
    Unsharded the unit is one iteration, ``sync_horizon`` of them a
    horizon: on the card ``capture_iteration``, on the CPU the eager body.
    Under a mesh (``sharding`` and its ``flags``) it is the masked
    ``sync_horizon`` group, one a horizon: on the card
    ``capture_horizon(flags=)``, on the CPU a sharded ``solve_chunk`` (the
    plain driver reads the flags after it)."""
    dev = torch.device(device)
    if sharding is None:
        if dev.type == "cuda":
            return (lambda c: capture_iteration(sde, score_fn, c, config=cfg)), sync_horizon
        return _iteration(sde, score_fn, cfg)[0], sync_horizon
    if dev.type == "cuda":
        return (lambda c: capture_horizon(sde, score_fn, c, sync_horizon=sync_horizon,
                                          config=cfg, sharding=sharding, flags=flags)), 1
    return (lambda c: solve_chunk(sde, score_fn, c, max_sync_iters=sync_horizon, config=cfg,
                                  sharding=sharding)), 1


class HorizonDriver:
    """The device-resident driver of one carry kept in place: the
    reference's ``solve_horizons`` over ``solve_chunk`` chunks, built once
    and run every window, one ``unit`` of the loop at a time.

    ``unit`` is the one callable the carry's device uses. On the card,
    ``unit(carry)`` captures one unit over the carry's buffers, which
    become static (``capture_iteration``, ``capture_horizon`` or
    ``capture_graph``, returning the graph), and a WHILE node replays it
    while P2 (``kernels.graph_loop.ops.WhileDriver``) says so: inside a
    horizon of at most ``horizon`` units while some row of the carry is
    not done and its ``iterations`` are below ``max_iters``, and from one
    horizon to the next until an event is pending, no occupied row runs,
    or ``max_horizons`` ran. CUDA 12.3 or later is needed in the toolkit
    and the driver, and an older one raises naming both. On the CPU,
    ``unit(carry) -> carry`` runs one unit in the plain loop
    (``kernels.graph_loop.ref``) under the same conditions, and the result
    is copied into the same buffers, so a window leaves the carry's
    tensors where they were either way. ``window()`` returns ``state``, a
    (4,) int32 on the device (``graph_loop.ops.STATE``): the event flag at
    exit, the horizons run, 0, and the units run, which the caller reads
    once and hands (the units) to ``account``.

    Under a mesh ``flags`` (``MeshFlags``) makes the condition global: the
    unit is a horizon's masked group (``horizon`` 1) and on the card must
    capture ``flags.update`` at its end (``capture_horizon(flags=)``), the
    WHILE node's P2 reads the agreed virtual slots and the agreed
    ``iterations``, and each window first runs ``flags.update`` once
    eagerly (no host read) for the condition it starts from; on the CPU
    the plain loop reads ``flags.masks`` after every unit. On CUDA
    tensors the mesh must be NCCL's: a gloo collective cannot be
    captured, so a gloo mesh raises here rather than fall back to a
    host-driven loop.
    """

    def __init__(self, carry: SolverCarry, occupied: Tensor, unit: Callable, *,
                 horizon: int, max_iters: int, max_horizons: int, wait_all: bool = False,
                 flags: Optional[MeshFlags] = None):
        self.carry = own_buffers(carry)
        self.occupied = occupied
        self.unit = unit
        self.max_horizons = int(max_horizons)
        self.horizon = int(horizon)
        self.max_iters = int(max_iters)
        self.wait_all = bool(wait_all)
        self.flags = flags
        dev = carry.x.device
        self.state = torch.zeros(len(loop_ops.STATE), dtype=torch.int32, device=dev)
        self.graph = self.driver = None
        t0 = time.perf_counter()
        if dev.type == "cuda":
            loop_ops.require_conditional_nodes()
            occ, done = occupied, self.carry.done
            if flags is not None:
                if not mesh_capturable(flags.group):
                    raise ValueError(
                        "the device-resident driver under a mesh captures the mesh's "
                        "all-reduce into its CUDA graph, and gloo collectives cannot be "
                        f"captured (this mesh's backend: {dist.get_backend(flags.group)}); "
                        "serve device-resident on an NCCL mesh, or host-driven on gloo")
                flags.update(self.carry)  # makes NCCL's communicator before the capture
                occ, done = flags.occupied_v, flags.done_v
            self.graph = unit(self.carry)
            self.driver = loop_ops.WhileDriver(self.graph, occ, done, self.carry.iterations,
                                               self.state, recorded=self.graph.recorded,
                                               horizon=self.horizon, max_iters=self.max_iters,
                                               max_horizons=self.max_horizons,
                                               wait_all=self.wait_all)
        #: unit graphs captured (one a driver, none on the CPU)
        self.captures = int(self.graph is not None)
        #: host seconds the capture (its warm-up iteration included) and
        #: the driver graph's instantiation took
        self.build_s = time.perf_counter() - t0

    def window(self) -> Tensor:
        """One driver window; reads nothing back on the card."""
        if self.driver is not None:
            if self.flags is not None:
                self.flags.update(self.carry)
            self.driver.launch()
            return self.state
        with torch.no_grad():
            out, event, n, units = loop_ref.solve_horizons(
                self.unit, self.carry, self.occupied, horizon=self.horizon,
                max_iters=self.max_iters, max_horizons=self.max_horizons,
                wait_all=self.wait_all,
                masks=None if self.flags is None else self.flags.masks)
            copy_carry_(self.carry, out)
        self.state.copy_(torch.tensor([int(event), n, 0, units], dtype=torch.int32))
        return self.state

    def account(self, units: int) -> None:
        """On the card, charge a window's kernel launches (``units`` read
        from its state) to the wrappers' counts (``WhileDriver.account``)
        and the collectives the unit's capture booked to the books
        (``collectives.charge``), once a unit run; the CPU launches nothing
        and books its calls as it makes them."""
        if self.driver is not None:
            self.driver.account(units)
            coll.charge(self.graph.books, units)


def solve_horizons(sde: SDE, score_fn: Callable, carry: SolverCarry, occupied: Tensor, *,
                   sync_horizon: int, max_horizons: int,
                   config: AdaptiveConfig | None = None, wait_all: bool = False,
                   sharding=None, **overrides):
    """Multi-horizon driver (DESIGN.md §12): chain ``sync_horizon``-bounded
    chunks until a serving event is pending (``events_pending``), every
    occupied sample converged, or ``max_horizons`` chunks ran. Returns
    ``(carry, events)``, the flag a 0-d bool on the device.

    Each horizon is the chunk the host-driven serve loop runs a sync, so
    the result is the chained chunks' bit for bit; inside it the
    iterations stop where ``solve_chunk``'s condition fails, as the
    reference's do. On the card this call captures the unit
    (``horizon_unit``) and runs one window of a ``HorizonDriver`` (the
    serve loop keeps its driver across windows instead). On the CPU it is
    the plain loop over the same unit. Either way the carry's buffers
    are written in place, as the reference donates its carry: a tensor
    the carry shares with the caller (``init_carry``'s ``x_init``) is
    overwritten. Under a mesh (``sharding``) ``carry`` and ``occupied``
    hold this rank's rows, and the flag is the whole mesh's
    (``MeshFlags``).
    """
    cfg = resolve_config(config, overrides)
    flags = None
    if sharding is not None:
        flags = MeshFlags(sharding, occupied, horizon=sync_horizon,
                          draws=draws_per_iteration(cfg))
    unit, horizon = horizon_unit(sde, score_fn, cfg, sync_horizon=sync_horizon,
                                 device=carry.x.device, sharding=sharding, flags=flags)
    drv = HorizonDriver(carry, occupied, unit, max_horizons=max_horizons, horizon=horizon,
                        max_iters=cfg.max_iters, wait_all=wait_all, flags=flags)
    state = drv.window()
    return drv.carry, state[0].to(torch.bool)


# ---------------------------------------------------------------------------
# The graphed whole solve and its driver cache
# ---------------------------------------------------------------------------

#: drivers the graph cache keeps at once (the reference's
#: ``lru_cache(maxsize=8)``)
GRAPH_CACHE_SIZE = 8
#: keys whose first solve ran host-driven that the cache remembers at once
#: (the one-shot rule, ``cached_driver``)
SEEN_SIZE = 64


class GraphKey(NamedTuple):
    """What a cached driver is keyed by: structure, not per-solve values.
    ``family`` names the solver loop, ``fns`` the identities of the
    functions the graph calls (a bound method by its object and function),
    ``static`` the family's settings that shape the graph (its config with
    the per-solve values taken out, the horizon), ``max_horizons`` the
    horizons a window may run, ``signature`` the carry's leaf shapes and
    dtypes (``_signature``), ``mesh`` the mesh and the rows a rank solves
    (``_mesh_key``; None unsharded), ``state`` what each function's
    ``graph_state()`` returned (None for one without it)."""

    family: str
    sde: Any
    fns: tuple
    static: tuple
    max_horizons: int
    signature: tuple
    mesh: Optional[tuple]
    state: tuple


_drivers: "collections.OrderedDict[GraphKey, HorizonDriver]" = collections.OrderedDict()
_seen: "collections.OrderedDict[GraphKey, tuple]" = collections.OrderedDict()
#: horizon graphs the cache's drivers captured since the count was last set to 0
captures = 0
#: drivers the cache built since the count was last set to 0 (on the card one
#: capture each, on the CPU none)
builds = 0


def graphable(generator, noise_fn: Callable | None = None, sharding=None, *,
              draws: bool = True) -> bool:
    """Whether a solve may run graphed (the one rule every solver asks):
    no ``noise_fn``; for a solver that ``draws`` noise, a ``SlotStreams``;
    and under a mesh (``sharding``) on the card, an NCCL mesh. A
    ``noise_fn`` or a list of per-slot sources is Python a graph cannot
    call; a ``torch.Generator``'s Philox offset is set by the host at each
    launch, so every body iteration inside one WHILE-node launch would
    draw the same noise. A graphed solve under a mesh captures the mesh's
    collectives (the flags' all-reduce, the RK45's error sum), and gloo
    collectives cannot be captured: on the card a gloo mesh runs the
    host-driven loop by this rule, not as a fallback. On the CPU the
    cached plain driver runs under any backend. A deterministic solver
    (``ddim``, ``ode``: ``draws=False``) needs no streams."""
    if noise_fn is not None:
        return False
    if (sharding is not None and sharding.mesh.device.type == "cuda"
            and not mesh_capturable(sharding.mesh.group())):
        return False
    return not draws or isinstance(generator, SlotStreams)


def _anchor(fn: Callable) -> tuple:
    """(the object whose life a cached driver follows, the function called
    on it): a bound method's object and function (a bound method is made
    anew at each attribute access), else the callable itself and None."""
    if inspect.ismethod(fn):
        return fn.__self__, fn.__func__
    return fn, None


def _forget(ident: tuple) -> None:
    """Drop the drivers and the records of a function that was collected.
    The collector stays off while the tables are read: a collection there
    could run another function's callback, which would change them under
    the read."""
    tables = [t for t in (_drivers, _seen) if t]  # None at interpreter exit, or empty
    if not tables:
        return
    enabled = gc.isenabled()
    gc.disable()
    try:
        for table in tables:
            for key in [k for k in table if ident in k.fns]:
                table.pop(key, None)
    finally:
        if enabled:
            gc.enable()


def _signature(carry) -> tuple:
    """The carry's structure: the device, the payload's names, and each
    field's tensor leaves as (shape, dtype), None for an empty field."""
    leaves = tuple(
        None if getattr(carry, f.name) is None else
        tuple((tuple(t.shape), t.dtype) for t in _tensor_leaves(getattr(carry, f.name)))
        for f in dataclasses.fields(carry))
    cond = getattr(carry, "cond", None)
    return (str(carry.x.device), None if cond is None else tuple(sorted(cond))) + leaves


def _mesh_key(sharding) -> Optional[tuple]:
    """A sharded solve's mesh in its ``GraphKey``: the mesh's identity
    (``Mesh.key``) and the rows of ``sharding`` the rank solves; None
    unsharded."""
    if sharding is None:
        return None
    rows = sharding.rows
    return sharding.mesh.key() + (sharding.axes, sharding.batch, rows.start, rows.stop)


def _graph_state(fns: tuple) -> tuple:
    """Each function's ``graph_state()`` (the port's score closures carry
    their net's, ``models.layers.graph_state``), None for one without it."""
    return tuple(None if getattr(f, "graph_state", None) is None else f.graph_state()
                 for f in fns)


#: the one-shot rule's branches, in the order the mesh's agreement takes
#: the least: the host-driven loop, a capture, a replay
HOST, CAPTURE, REPLAY = 0, 1, 2


def agree_branch(branch: int, mesh, device) -> int:
    """The one-shot rule's branch the whole ``mesh`` takes: the
    least of every rank's ``branch``, by one all-reduce (MAX of its
    negation, booked as loop control) and one host read (``host_syncs``).
    A rank's cache can differ from another's (an eviction, a collected
    function, a cleared cache), and a rank that replays or captures while
    another runs host-driven would wait in a collective forever."""
    t = torch.full((1,), -int(branch), dtype=torch.int32, device=device)
    all_max(t, mesh)
    return -int(host_read(t)[0])


def _then_update(run: Callable, flags: "MeshFlags") -> Callable:
    """``run`` followed by the mesh's agreement on its flags, in place."""

    def horizon(c):
        copy_carry_(c, run(c))
        flags.update(c)
        return c

    return horizon


def cached_driver(family: str, sde, fns: tuple, static: tuple, carry,
                  make_horizon: Callable, *, max_horizons: int, horizon: int = 1,
                  max_iters: int = UNBOUNDED, sharding=None,
                  flags: Optional[Callable] = None) -> Optional[HorizonDriver]:
    """The cached driver of ``family``'s unit, ``horizon`` units a horizon
    and at most ``max_horizons`` horizons a window while ``carry.iterations``
    stays below ``max_iters`` (``HorizonDriver``), waiting on every row of
    ``carry.done``, with ``carry`` copied into its buffers; None where the
    solve is to run host-driven. ``static`` must settle ``horizon`` and
    ``max_iters``: the parent graph holds them.

    ``make_horizon(*fns) -> (run, warm)`` builds the unit on the live
    functions: ``run(carry) -> carry`` the unit, ``warm(carry)`` one
    iteration of it (the capture's warm-up). On the card ``run`` is
    captured (``capture_graph``) and counted in ``captures``; on the CPU
    it is the plain driver's unit. ``carry`` needs the leaves ``x``,
    ``done`` and ``iterations``.

    The one-shot rule: a key's first solve is host-driven (None) and
    records the key, its second builds the driver (on the card: one
    capture), later solves replay it. A process that solves once at a key
    (the ``launch.sample`` CLI, a table row) pays no capture, and since
    the graph is bitwise the host-driven chain, the result does not
    depend on which solve ran which way.

    Under a mesh (``sharding``: ``carry`` holds this rank's rows) the key
    holds the mesh (``_mesh_key``), and every rank takes the branch the
    mesh agrees on (``agree_branch``: the least of host-driven, capture,
    replay): a rank holding a driver where the mesh agreed to capture
    drops it and captures again, and where the mesh agreed on the
    host-driven loop a rank keeps the driver it holds. ``flags(occupied)
    -> MeshFlags`` makes the mesh's flags of a horizon whose rows can
    finish at other iterations on other ranks (Algorithm 1's families):
    the horizon then ends in their all-reduce, captured with it on the
    card, and the window's condition reads the whole mesh's rows. A
    family whose condition is the same on every rank by construction
    (the fixed grids' step, the RK45's s) passes none.

    The cache is the reference's ``_chunk_jit``/``_finalize_jit``: at
    most ``GRAPH_CACHE_SIZE`` drivers, least recently used out first,
    keyed by a ``GraphKey``, each function by identity and by the value
    of its ``graph_state()``, where it has one: the port's score closures
    carry their net's config, ``training`` flag and every parameter's and
    buffer's (data_ptr, shape, dtype), so a flipped ``use_flash``, a
    ``cast_params`` or a parameter bound to a new tensor is a new key,
    and an in-place optimizer step is not. A hit copies the fresh carry
    (prior, per-solve values, stream seeds, payload) into the driver's
    captured buffers and captures nothing. The records and the drivers
    hold ``fns`` (a bound method's object) weakly: once one is collected
    its drivers, their graphs and their pools go with it, so a dropped
    model leaves nothing on the card. A function that takes no weak
    reference is never recorded: its solves all run host-driven. A cached
    graph replays what it captured: a function without ``graph_state``
    whose behaviour follows Python state (a flag on its model, a swapped
    module) is keyed by its identity alone, so it must be a new function,
    or the cache cleared (``clear_graph_cache``), when that state
    changes."""
    global captures, builds
    anchors = [_anchor(f) for f in fns]
    idents = tuple((id(obj), func) for obj, func in anchors)  # identity: a net may define __eq__
    key = GraphKey(family, sde, idents, tuple(static), int(max_horizons), _signature(carry),
                   _mesh_key(sharding), _graph_state(fns))
    drv = _drivers.get(key)
    try:  # neither the record nor the driver keeps a strong reference to fns
        refs = tuple(weakref.ref(obj, lambda _, ident=ident: _forget(ident))
                     for (obj, _), ident in zip(anchors, idents))
    except TypeError:  # takes no weak reference: never recorded, always host-driven
        refs = None
    branch = (REPLAY if drv is not None else
              CAPTURE if refs is not None and key in _seen else HOST)
    if sharding is not None:
        branch = agree_branch(branch, sharding.mesh, carry.x.device)
    if branch == REPLAY:
        _drivers.move_to_end(key)
        copy_carry_(drv.carry, carry)
        return drv
    if branch == HOST:
        if refs is not None and key not in _seen:  # the key's first solve
            _seen[key] = refs
            while len(_seen) > SEEN_SIZE:
                _seen.popitem(last=False)
        return None
    _drivers.pop(key, None)  # a driver the mesh agreed not to replay
    if key in _seen:
        _seen.move_to_end(key)
    funcs = tuple(func for _, func in anchors)
    del anchors, fns  # the unit below must not hold the functions

    def live() -> tuple:
        return tuple(ref() if func is None else func.__get__(ref())
                     for ref, func in zip(refs, funcs))

    occupied = torch.ones(carry.done.shape[0], dtype=torch.bool, device=carry.x.device)
    mesh_flags = None if flags is None else flags(occupied)
    if carry.x.device.type == "cuda":
        def unit(c):
            run, warm = make_horizon(*live())
            if mesh_flags is not None:
                run = _then_update(run, mesh_flags)
            return capture_graph(c, run, warm)
    else:  # the plain driver reads the flags after every horizon (``HorizonDriver``)
        unit = lambda c: make_horizon(*live())[0](c)
    drv = HorizonDriver(copy.deepcopy(carry), occupied, unit, max_horizons=max_horizons,
                        horizon=horizon, max_iters=max_iters, wait_all=True, flags=mesh_flags)
    captures += drv.captures
    builds += 1
    drv.anchor = refs  # lives as long as the entry: their callbacks drop it
    _drivers[key] = drv
    while len(_drivers) > GRAPH_CACHE_SIZE:
        _drivers.popitem(last=False)
    return drv


def clear_graph_cache() -> None:
    """Drop every cached driver (and the graphs and buffers it holds) and
    every record of a key's first solve."""
    _drivers.clear()
    _seen.clear()


def host_read(flags: Tensor) -> list:
    """``flags.tolist()``, counted in ``host_syncs``: the solvers'
    device→host reads."""
    global host_syncs
    host_syncs += 1
    return flags.tolist()


def driver_window(drv: HorizonDriver) -> tuple:
    """One driver window and its one host read: (horizons run, some row
    still active, iterations), the window's launches charged (its units
    run). Under a mesh with flags the activity is the whole mesh's (the
    flags' last agreement), so every rank reads the same."""
    drv.window()
    c = drv.carry
    active = ((~c.done).any().to(torch.int32).reshape(1) if drv.flags is None
              else drv.flags.buf[:1])
    event, horizons, _, units, active, iters = host_read(
        torch.cat([drv.state, active, c.iterations.reshape(1)]))
    drv.account(units)
    return horizons, bool(active), iters


def solve_cached(family: str, sde, fns: tuple, static: tuple, carry, make_horizon: Callable,
                 *, max_horizons: int, host: Callable, horizon: int = 1,
                 max_iters: int = UNBOUNDED, sharding=None):
    """The whole solve of ``carry`` in one window of the cached driver
    (``cached_driver``: ``horizon``, ``max_iters`` and ``max_horizons``
    its bounds), or ``host(carry) -> carry``, the host-driven chain, where
    the one-shot rule says so. Returns a carry of its own (the driver's
    buffers serve the next solve). ``sharding``: the mesh the solve's rows
    lie on, whose condition is the same on every rank (the fixed grids',
    the RK45's)."""
    drv = cached_driver(family, sde, fns, static, carry, make_horizon,
                        max_horizons=max_horizons, horizon=horizon, max_iters=max_iters,
                        sharding=sharding)
    if drv is None:
        return host(carry)
    driver_window(drv)
    return copy.deepcopy(drv.carry)


def graph_driver(sde: SDE, score_fn: Callable, carry: SolverCarry, config: AdaptiveConfig, *,
                 max_sync_iters: int, max_horizons: int,
                 sharding=None) -> Optional[HorizonDriver]:
    """Algorithm 1's cached driver (``cached_driver``): horizons of at most
    ``max_sync_iters`` iterations, each its own unit (on the card
    ``capture_iteration``'s graph, on the CPU the eager body; P2 ends a
    horizon where ``solve_chunk``'s condition fails), at most
    ``max_horizons`` a window, or None where the one-shot rule runs the
    solve host-driven. The key holds the
    config without its tolerances: ``eps_rel`` and ``eps_abs`` go into
    the carry as its per-sample ``rtol``/``atol`` leaves (where the
    caller set none), which the body reads in place of the config's and
    which round as the config's floats do, so solves that differ only in
    their tolerances share a driver.

    Under a mesh (``sharding``, the carry this rank's rows) the unit is
    the masked ``max_sync_iters`` iterations on both devices, one a
    horizon, ended by the mesh's flags (``MeshFlags``: the all-reduce of
    [a row running, iterations] and a lagging rank's catch-up), which the
    host-driven chain makes after each group of ``SYNC_EVERY``: an
    iteration with no active row changes nothing and the catch-up of a
    lag is the sum of its parts, so the window is the chain bit for
    bit."""
    if carry.atol is None:
        carry = dataclasses.replace(
            carry, atol=_per_sample(_eps_abs(sde, config), carry.batch, carry.x.device),
            rtol=_per_sample(config.eps_rel, carry.batch, carry.x.device))
    static = (dataclasses.replace(config, eps_rel=None, eps_abs=None), int(max_sync_iters))


    def make_horizon(score):
        if sharding is None:
            return _iteration(sde, score, config)
        return _horizon(sde, score, config, max_sync_iters, sharding)

    flags = None
    if sharding is not None:
        flags = lambda occupied: MeshFlags(sharding, occupied, horizon=max_sync_iters,
                                           draws=draws_per_iteration(config))
    return cached_driver("adaptive", sde, (score_fn,), static, carry, make_horizon,
                         max_horizons=max_horizons,
                         horizon=max_sync_iters if sharding is None else 1,
                         max_iters=config.max_iters, sharding=sharding, flags=flags)


def solve_graphed(sde: SDE, score_fn: Callable, carry: SolverCarry, *,
                  config: AdaptiveConfig, sharding=None) -> SolverCarry:
    """The whole solve of ``carry`` (its noise a ``SlotStreams``): one window
    of the cached driver until every row (under a mesh, every rank's) has
    converged or ``max_iters`` iterations ran; or, at a key's first solve,
    the host-driven ``solve_chunk`` chain. Unsharded the window is the
    reference's one ``solve_chunk`` of ``max_iters`` iterations, its
    condition checked after every iteration; under a mesh it is
    ``SYNC_EVERY``-iteration masked groups, at most
    ⌈``max_iters``/``SYNC_EVERY``⌉. Returns a carry of its own (the
    driver's buffers serve the next solve)."""
    budget = max(config.max_iters, 1)  # a parent graph holds a horizon of one unit or more
    group, horizons = ((budget, 1) if sharding is None
                       else (SYNC_EVERY, -(-budget // SYNC_EVERY)))
    drv = graph_driver(sde, score_fn, carry, config, max_sync_iters=group,
                       max_horizons=horizons, sharding=sharding)
    if drv is None:
        return solve_chunk(sde, score_fn, carry, max_sync_iters=config.max_iters,
                           config=config, sharding=sharding)
    driver_window(drv)
    return copy.deepcopy(drv.carry)


def finalize(sde: SDE, score_fn: Callable, carry: SolverCarry, *,
             denoise: bool = True, precision="fp32",
             conditioner: Optional[Conditioner] = None) -> SolveResult:
    """SolveResult from a finished carry, plus the paper's Tweedie denoise
    (one more score evaluation, fp32 arithmetic).

    With a ``conditioner`` the denoising score is the conditioned field
    (consuming ``carry.cond``), and the delivered sample gets the exact
    ``finalize_project`` (inpainting pins observed coordinates exactly).
    """
    policy = resolve_policy(precision)
    if conditioner is not None:
        score_fn = conditioner.wrap_score(score_fn, carry.cond)
    x, nfe = carry.x, carry.nfe
    if denoise:
        t = torch.full((carry.batch,), sde.t_eps, dtype=torch.float32,
                       device=x.device)
        with torch.no_grad():
            score = score_fn(policy.to_compute(x), t).to(torch.float32)
        x = sde.tweedie_denoise(x.to(torch.float32), score)
        nfe = nfe + 1
    if conditioner is not None:
        x = conditioner.finalize_project(x, carry.cond)
    return SolveResult(x=x, nfe=nfe, iterations=carry.iterations,
                       accepted=carry.accepted, rejected=carry.rejected)


@register_solver("adaptive", nfe_per_iter=2)
def adaptive(sde: SDE, score_fn: Callable, x_init: Tensor,
             generator: Optional[torch.Generator] = None, *,
             config: AdaptiveConfig | None = None, denoise: bool = True,
             cond=None, atol=None, rtol=None, h0=None,
             noise_fn: Callable | None = None, device="cuda", sharding=None,
             **overrides) -> SolveResult:
    """Algorithm 1: solve the reverse diffusion from T to t_eps adaptively.

    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``);
    ``x_init`` is moved there. ``generator`` (on the same device) feeds
    the noise draws unless ``noise_fn`` is given.

    The loop the solve runs is chosen by the noise source and the mesh
    (``graphable``). A ``SlotStreams`` generator without ``noise_fn`` is
    the graphed solve (module docstring): on the card one WHILE-node
    launch of the cached driver (``graph_driver``) and one host read
    (under a mesh two: the branch's agreement and the window), bitwise
    the host-driven chain on the same streams. The other sources, and a
    gloo mesh on the card, stay on ``solve_chunk``'s host-driven groups,
    one host read a group. ``cond`` is the payload of
    ``cfg.conditioner`` (DESIGN.md §9). ``atol``/``rtol``/``h0`` install
    per-sample tolerances and initial steps (DESIGN.md §14). ``sharding`` (a batch ``RowSharding`` of a mesh, normally from
    ``sample(mesh=)``) makes the solve data-parallel: the arguments are
    global, and the result holds this rank's rows, with the global
    ``iterations`` (see the module docstring for when it is bitwise the
    unsharded result's rows).
    """
    dev = resolve_device(device)
    check_noise_source(generator, noise_fn, dev, "adaptive")
    cfg = resolve_config(config, overrides)
    carry = init_carry(sde, x_init.to(dev), generator, config=cfg, cond=cond,
                       atol=atol, rtol=rtol, h0=h0, sharding=sharding)
    if graphable(generator, noise_fn, sharding):
        carry = solve_graphed(sde, score_fn, carry, config=cfg, sharding=sharding)
    else:
        carry = solve_chunk(sde, score_fn, carry, max_sync_iters=cfg.max_iters,
                            config=cfg, noise_fn=noise_fn, sharding=sharding)
    return finalize(sde, score_fn, carry, denoise=denoise,
                    precision=cfg.precision, conditioner=cfg.conditioner)


# ---------------------------------------------------------------------------
# Algorithm 2: arbitrary forward-time diffusion dx = f(x,t)dt + g(x,t)dw
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ForwardAdaptiveConfig:
    eps_rel: float = 0.01
    eps_abs: float = 1e-3
    h_init: float = 0.01
    safety: float = 0.9
    r_exponent: float = 0.9
    max_iters: int = 100_000
    stratonovich: bool = False  # True (or a state-independent g) → s = 0


@dataclasses.dataclass
class ForwardCarry:
    """State of an Algorithm-2 solve between iterations: x, x_prev, the
    kept (z, s) draw, t and h as ``SolverCarry``'s; done: (B,) bool, t at
    its end; iterations 0-d int32; generator: a ``SlotStreams`` (the
    graphed path) or the host-driven path's ``torch.Generator``."""

    x: Tensor
    x_prev: Tensor
    t: Tensor
    h: Tensor
    z: Tensor
    s: Tensor
    nfe: Tensor
    accepted: Tensor
    rejected: Tensor
    iterations: Tensor
    done: Tensor
    generator: Any = None


def _forward_draw(generator, x: Tensor, offset: int = 0):
    """(z, s): z ~ N(0, I) of x's shape, then s ~ U{−1, +1} per sample
    (fp32). From a ``torch.Generator``: z, then s from ``randint``. From a
    ``SlotStreams``: z is row i's draw at counter + ``offset`` and s the
    sign of its one-normal draw at counter + ``offset`` + 1 (P1, two
    launches), the per-row form of the reference's
    ``jax.random.rademacher``."""
    if isinstance(generator, SlotStreams):
        z = generator.draw(x.shape[1:], offset)
        n = generator.draw((1,), offset + 1)[:, 0]
        return z, torch.where(n < 0, -1.0, 1.0)
    z = torch.randn(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    s = torch.randint(0, 2, (x.shape[0],), generator=generator, device=x.device)
    return z, (2 * s - 1).to(torch.float32)


#: counters an Algorithm-2 draw takes from a ``SlotStreams``: z, then s
FORWARD_DRAWS = 2


def _forward_body(drift_fn: Callable, diffusion_fn: Callable, t_end: float,
                  cfg: ForwardAdaptiveConfig, noise: Callable) -> Callable:
    """One Algorithm-2 iteration, ``body(carry) -> carry``, masked: a sample
    is active while t < t_end and ``iterations < cfg.max_iters``, and an
    iteration with no active sample changes no leaf (the stream counters
    move by ``FORWARD_DRAWS`` only in an iteration with one)."""
    end = t_end - 1e-12

    def body(c: ForwardCarry) -> ForwardCarry:
        x, x_prev, t, h, z, s = c.x, c.x_prev, c.t, c.h, c.z, c.s
        active = (t < end) & (c.iterations < cfg.max_iters)
        h_c = torch.where(active, torch.minimum(h, t_end - t), 0.0)
        hb, sq, se = bcast(h_c, x), bcast(torch.sqrt(h_c), x), bcast(s, x)
        g1, f1 = diffusion_fn(x, t), drift_fn(x, t)
        x_prime = x + hb * f1 + sq * g1 * (z - se)
        t2 = t + h_c
        g2, f2 = diffusion_fn(x_prime, t2), drift_fn(x_prime, t2)
        x_tilde = x + hb * f2 + sq * g2 * (z + se)
        x_high = 0.5 * (x_prime + x_tilde)
        delta = mixed_tolerance(x_prime, x_prev, cfg.eps_abs, cfg.eps_rel)
        err = scaled_error_l2(x_prime, x_high, delta)
        accept = (err <= 1.0) & active
        acc_e = bcast(accept, x)
        t_new = torch.where(accept, t + h_c, t)
        z_fresh, s_fresh = noise(c.generator, x)  # drawn every iteration, kept only on accept
        remaining = torch.clamp(t_end - t_new, min=0.0)
        h_new = next_step_size(h, err, remaining, safety=cfg.safety,
                               r_exponent=cfg.r_exponent)
        any_active = active.any()
        gen = c.generator
        if isinstance(gen, SlotStreams):
            gen = gen.advanced(any_active.to(torch.int64) * FORWARD_DRAWS)
        return ForwardCarry(
            x=torch.where(acc_e, x_high, x), x_prev=torch.where(acc_e, x_prime, x_prev),
            t=t_new, h=torch.where(active, h_new, h),
            z=torch.where(acc_e, z_fresh, z), s=torch.where(accept, s_fresh, s),
            nfe=c.nfe + torch.where(active, 2, 0).to(torch.int32),
            accepted=c.accepted + accept.to(torch.int32),
            rejected=c.rejected + (~accept & active).to(torch.int32),
            iterations=c.iterations + any_active.to(torch.int32),
            done=~(t_new < end), generator=gen)

    return body


def adaptive_forward(drift_fn: Callable, diffusion_fn: Callable, x0: Tensor,
                     t_begin: float, t_end: float, generator=None, *,
                     config: ForwardAdaptiveConfig | None = None,
                     noise_fn: Callable | None = None, device="cuda") -> SolveResult:
    """Algorithm 2 (paper App. C): the forward-time adaptive solver for a
    general diffusion dx = f(x, t) dt + g(x, t) dw, x (B, ...) fp32.

    As Algorithm 1 but forward in time; g may depend on x, which the Itô
    correction s ~ U{−1, +1} per sample (Roberts 2012) handles, unless
    ``stratonovich`` (s = 0); and the Gaussian z is kept across
    rejections, so a rejection does not bias the driving noise (only an
    accepted sample gets a fresh z and s).

    Noise: one (z, s) draw before the loop and one every iteration, from
    ``generator`` (a ``torch.Generator`` or a ``SlotStreams`` on
    ``device``, ``_forward_draw``) or from ``noise_fn(x) -> (z, s)``, the
    seam through which tests pass the reference's draws. A stream's
    counter moves by ``FORWARD_DRAWS`` a draw: the first draw is at its
    counter, and an iteration in which some sample is active moves it on.

    The loop is chosen as Algorithm 1's (``graphable``): with a
    ``SlotStreams`` and no ``noise_fn`` the solve is one window of a
    cached driver (``solve_cached``: on the card one WHILE-node launch
    whose body is one iteration and whose condition, the reference's
    ``any(t < t_end) ∧ iterations < max_iters``, P2 evaluates after every
    one; one host read; a key's first solve host-driven), keyed by
    ``drift_fn``, ``diffusion_fn``, the config, ``t_end`` and the state's
    shape. Otherwise iterations run in groups of ``SYNC_EVERY`` between
    host reads. An iteration after every sample finished changes
    nothing, and ``iterations`` counts those in which a sample was
    active, which is the reference's count: the graphed solve is the
    host-driven one bit for bit, without the host groups' masked tail.
    """
    dev = resolve_device(device)
    check_noise_source(generator, noise_fn, dev, "adaptive_forward")
    cfg = config or ForwardAdaptiveConfig()
    t_end = float(t_end)

    def noise(gen, x):
        z, s = noise_fn(x) if noise_fn is not None else _forward_draw(gen, x)
        z, s = z.to(device=dev, dtype=torch.float32), s.to(device=dev, dtype=torch.float32)
        return z, (torch.zeros_like(s) if cfg.stratonovich else s)

    x = x0.to(device=dev, dtype=torch.float32)
    batch = x.shape[0]
    t = torch.full((batch,), float(t_begin), dtype=torch.float32, device=dev)
    h = torch.clamp(torch.full((batch,), cfg.h_init, dtype=torch.float32, device=dev),
                    max=t_end - t_begin)
    z, s = noise(generator, x)
    if isinstance(generator, SlotStreams):
        generator = generator.advanced(FORWARD_DRAWS)
    zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
    carry = ForwardCarry(x=x, x_prev=x, t=t, h=h, z=z, s=s, nfe=zeros, accepted=zeros,
                         rejected=zeros, iterations=torch.zeros((), dtype=torch.int32,
                                                                device=dev),
                         done=~(t < t_end - 1e-12), generator=generator)

    def host(c: ForwardCarry) -> ForwardCarry:
        body = _forward_body(drift_fn, diffusion_fn, t_end, cfg, noise)
        while True:
            active, n_iters = host_read(torch.stack([(~c.done).any().to(torch.int32),
                                                     c.iterations]))
            if not active or n_iters >= cfg.max_iters:
                return c
            for _ in range(min(SYNC_EVERY, cfg.max_iters - n_iters)):
                c = body(c)

    def make_horizon(drift, diffusion):
        body = _forward_body(drift, diffusion, t_end, cfg, noise)
        return body, body  # one step a unit; the warm-up is a step

    with torch.no_grad():
        if graphable(generator, noise_fn):
            budget = max(cfg.max_iters, 1)
            carry = solve_cached("forward", None, (drift_fn, diffusion_fn), (cfg, t_end),
                                 carry, make_horizon, max_horizons=1, horizon=budget,
                                 max_iters=cfg.max_iters, host=host)
        else:
            carry = host(carry)
    return SolveResult(x=carry.x, nfe=carry.nfe, iterations=carry.iterations,
                       accepted=carry.accepted, rejected=carry.rejected)
