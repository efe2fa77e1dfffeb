"""Continuous-batching diffusion sampling server (DESIGN.md §4, §7, §12);
port of ``repro/serving/diffusion_server.py``.

The paper's per-sample step sizes (Sec. 3.1.5) mean each sample of a
batch finishes its reverse diffusion at its own NFE. A server runs a
fixed slot batch of Algorithm-1 state and, whenever a slot's sample
reaches t_eps, delivers it and refills the slot with the next request's
prior draw: no request waits for the batch's slowest sample.

Horizon-chunked solve (DESIGN.md §7): the device step is the solver's
own ``solve_chunk`` (``launch.sample.make_sample_step``) over a
``SolverCarry`` whose noise comes from per-slot streams.
``sync_horizon`` Algorithm-1 iterations run per host sync; then the
host retires converged slots, compacts the survivors and admits queued
requests into the freed slots (a prior drawn from the request's own
stream at t = T). Every slot owns its noise stream, so a sample's
trajectory does not depend on its slot or its seatmates: compaction and
admission never perturb a sample in flight.

Per-request streams: by default a request's stream is device data, a
``SlotStreams`` row (seed ``ImageRequest.seed``, a counter) drawn by the
P1 kernel: the prior is the draw at counter 0, then one draw an
iteration (two with a projecting conditioner) from counter 1, the order
``sample(seed=...)`` draws in, so a request served with seatmates is
bitwise its solo batch-1 ``adaptive()`` on ``SlotStreams.of([seed], 1)``.
``request_streams`` replaces that: the parity tests hand every request
the reference's own prior and per-slot draws through it (Python
callables, which a CUDA graph cannot call).

What crosses the device: compaction permutes every carry leaf with one
``index_select`` on the device and admission writes the admitted rows
with ``index_copy_``, both in place; only the (B,) bookkeeping and the
retired rows come to the host, through ``_d2h``, which counts each read
(``host_transfers``). The solver's own syncs (one before and one after
each group of ``SYNC_EVERY`` iterations, ``adaptive.sync_state``) are
counted apart, in ``solver_syncs``.

Device-resident hot path (DESIGN.md §12; ``device_resident=True``): the
per-horizon polling loop moves to the device. A driver
(``adaptive.HorizonDriver``) chains sync-horizon chunks until a serving
event (a pending delivery) fires or ``MAX_HORIZONS`` ran, and the host
reads one (4,) int32 a window: the event flag, the horizons and the
units run. On the card the driver is one CUDA graph: one Algorithm-1
iteration captured once per server over the carry's static buffers,
inside a WHILE node whose condition is the P2 kernel
(``kernels.graph_loop``), which ends a chunk where the reference's
``solve_chunk`` stops (every sample converged, the horizon's iterations
run, the budget spent) and checks for an event only at a chunk's end,
so retirement keeps the horizon's granularity. On the CPU it is the
plain loop over the same iteration and conditions. Only when the flag
is set does the
host pull the (B,) bookkeeping and the retired rows and write the
permutation and the admissions into the same buffers in place
(``_process_events``), so host↔device traffic is O(delivered requests),
not O(sync horizons), and the delivered samples are the host-driven
loop's bit for bit.

Mesh scale-out (DESIGN.md §3; ``mesh=``): the slot batch shards over the
mesh's data axes, a rank of ``torch.distributed`` per data index. Each
rank's carry holds only its contiguous block of ``slots / n_devices``
rows, and compaction is shard-local: slots are permuted within their
block only, so no sample, stream or condition row crosses a rank, and
``refills_per_device`` counts each block's admissions. The host's books
(queue, slot table, counters) are the same on every rank, which is the
SPMD contract: every rank constructs the server and submits the same
requests in the same order, and every decision reads only global
values. At a sync the (B,) bookkeeping is gathered from every rank in
one collective (one ``_d2h`` read, as the reference's one
``device_get``), and the retired rows reach every rank's ``finished`` in
another; admission writes only the rows a rank owns. Every clock read
that a decision or a book depends on (submission stamps and deadlines,
EDF admission's ``now``, delivery) is rank 0's reading, broadcast over a
host (gloo) group, so the ranks seat the same requests. The
device-resident driver agrees on its event flag after every horizon
(``adaptive.MeshFlags``), and its unit is then the masked sync-horizon
chunk, one a horizon: on the card the NCCL all-reduce is captured
inside the WHILE node's body, and a gloo mesh on CUDA tensors raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.diffusion import ToleranceClass, resolve_tier
from repro_torch.core.precision import resolve_policy
from repro_torch.core.sde import SDE
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers.adaptive import AdaptiveConfig, HorizonDriver, SolverCarry
from repro_torch.core.solvers.base import SlotStreams, solver_nfe_per_iteration
from repro_torch.device import resolve_device
from repro_torch.observability.metrics import MetricsRegistry
from repro_torch.observability.telemetry import init_telemetry, telemetry_history
from repro_torch.observability.tracing import NULL_TRACER, profiler_annotation
from repro_torch.parallel.collectives import gather_retired, gather_rows, gather_slot_vectors
from repro_torch.serving.scheduler import (
    AdmissionPolicy, FifoAdmission, TierAccounting, tier_name,
)

Tensor = torch.Tensor

#: sync horizons one device-resident window runs at most (the reference's
#: default ``max_horizons``): how long newcomers wait for free slots
MAX_HORIZONS = 32


@dataclasses.dataclass
class ImageRequest:
    """One sampling request (DESIGN.md §4, §9, §14): a seed, optionally a
    condition payload for the server's conditioner, and, on a tiered
    server, a tolerance class, deadline and priority."""

    uid: int
    seed: int
    #: the request's unbatched condition payload (DESIGN.md §9), e.g.
    #: ``{"mask": (H, W, C), "observed": (H, W, C)}`` or ``{"label": ()}``;
    #: None (with a conditioner) is the neutral payload
    cond: Any = None
    #: tolerance class (DESIGN.md §14): a preset name of
    #: ``configs.diffusion.TOLERANCE_CLASSES`` (or of the server's own
    #: registry) or a ``ToleranceClass``; None rides the server's config
    tier: Any = None
    #: latency budget in ms from submission; None defers to the tier's
    deadline_ms: Optional[float] = None
    #: admission band, lower = more urgent; None defers to the tier's
    priority: Optional[int] = None
    result: Optional[np.ndarray] = None
    nfe: int = 0
    done: bool = False
    #: set at delivery: did the request outlive its deadline?
    deadline_missed: bool = False
    #: loop iterations spent in a slot (admission → retirement)
    resident_iters: int = 0
    #: accept/reject counts, pulled with the NFE at retirement (DESIGN.md
    #: §15); nfe == nfe_per_iter·(accepted + rejected)
    accepted: int = 0
    rejected: int = 0
    #: absolute deadline on the server's clock, stamped at submit()
    deadline_at: Optional[float] = dataclasses.field(default=None, repr=False)
    _admit_iters: int = dataclasses.field(default=0, repr=False)
    _submit_t: float = dataclasses.field(default=0.0, repr=False)
    _seat_t: float = dataclasses.field(default=0.0, repr=False)


@functools.cache
def _host_group(group):
    """A gloo group over the ranks of ``group`` (``group`` itself when it is
    gloo's): the mesh server's host-side agreement. Made once a group, in
    the same order on every rank."""
    if dist.get_backend(group) == "gloo":
        return group
    return dist.new_group(dist.get_process_group_ranks(group), backend="gloo")


class MeshClock:
    """Rank 0's clock on every rank of a mesh: each call reads ``clock`` on
    the mesh's first rank and broadcasts the value over a host group, so
    every rank stamps, orders and books with the same readings, in the
    same number and order as one unsharded server reads its clock."""

    def __init__(self, clock: Callable[[], float], mesh):
        self.clock = clock
        self.group = _host_group(mesh.group())
        self.src = int(np.asarray(mesh.ranks()).reshape(-1)[0])

    def __call__(self) -> float:
        t = torch.zeros(1, dtype=torch.float64)
        if dist.get_rank() == self.src:
            t[0] = self.clock()
        dist.broadcast(t, src=self.src, group=self.group)
        return float(t[0])


def _family(cfg: AdaptiveConfig) -> str:
    """The solver registry's name of the Algorithm-1 family ``cfg`` runs."""
    if cfg.probability_flow:
        return "heun"
    return "momentum" if cfg.momentum else "adaptive"


class DiffusionBatcher:
    """Slot-compacting sampler around a ``solve_chunk`` step.

    ``sample_step(params, carry, max_sync_iters=N) -> carry`` is the
    device step (``launch.sample.make_sample_step``). ``sync_horizon``
    iterations run between host syncs (1 is the per-step loop; larger
    horizons take fewer syncs for up to horizon − 1 iterations of
    retirement latency). ``compaction=True`` retires converged slots and
    admits queued requests at every sync; ``False`` is the
    monolithic-wave baseline, which turns the batch over only once every
    occupied slot has converged (the paper's batched loop).

    The carry's state dtype is ``cfg.precision``'s. With
    ``cfg.conditioner`` the carry holds a per-slot condition payload:
    idle slots the neutral one, an admitted request its own, and
    compaction moves payloads with their samples (DESIGN.md §9).

    ``tolerance_classes`` (DESIGN.md §14) turns on per-request quality
    tiers: the carry grows (B,) ``atol``/``rtol`` leaves, so each seated
    request solves at its own class's tolerance in one fused step (K2,
    the solver-step kernel with ε per row); a dict is this server's own
    name → ``ToleranceClass`` registry (default: the presets).
    ``admission`` picks which queued requests take free slots (FIFO by
    default) and ``delivery`` keeps per-class NFE and deadline books
    (``class_stats``). ``telemetry`` > 0 attaches a step-telemetry ring of
    that capacity a slot, ``tracer`` records stage spans, and every
    serve-loop counter lives in the ``metrics`` registry (DESIGN.md §15).

    ``device_resident=True`` (DESIGN.md §12) replaces the per-horizon
    host round trip with the device-resident driver: up to
    ``MAX_HORIZONS`` sync-horizon chunks a host visit, one read a window
    (module docstring), each chunk's iterations stopping where every
    sample converged. ``graph_captures`` counts the unit graphs the
    server captured (one on the card, at its first window);
    ``device_horizons`` and ``device_units`` the chunks and the units
    (iterations; under a mesh, chunks) its driver ran.

    ``solver``/``solver_kwargs`` name the solver family ``sample_step``
    runs, so that the waste books convert loop iterations to issued score
    evaluations with the registry's ``solver_nfe_per_iteration``. The
    batcher runs the Algorithm-1 body only, and ``cfg`` picks its family
    (``momentum`` with ``cfg.momentum``, ``heun`` with
    ``cfg.probability_flow``, else ``adaptive``): any other ``solver``
    raises ``ValueError``, so the books cannot take another family's rate.

    ``device`` holds the carry (``cuda`` unless the caller passes
    ``"cpu"``); ``request_streams(req, shape, device) -> (prior, source)``
    replaces the default per-request streams (module docstring); a
    device-resident server on the card refuses it.

    ``mesh`` (a ``repro_torch.parallel.Mesh``) shards the slots over its
    data axes (module docstring): ``n_devices`` is the product of the data
    axes, ``slots`` must divide by it (else ``ValueError``), and
    ``slots_per_device``, ``slot_device`` and ``refills_per_device`` are
    per data index. A mesh server is a collective: every rank of the mesh
    builds it, submits the same requests in the same order and drives it
    the same way; ``sample_step`` must take ``sharding=`` (and its
    ``horizon_unit`` ``sharding=`` and ``flags=``), as
    ``launch.sample.make_sample_step``'s does.
    """

    def __init__(self, sde: SDE, sample_step: Callable, params, sample_shape, *,
                 slots: int = 8, cfg: AdaptiveConfig | None = None, mesh=None,
                 sync_horizon: int = 1, compaction: bool = True,
                 device_resident: bool = False, solver: str = "adaptive",
                 solver_kwargs: Optional[dict] = None, tolerance_classes=None,
                 admission: Optional[AdmissionPolicy] = None, delivery=None,
                 clock: Optional[Callable[[], float]] = None, telemetry: int = 0,
                 tracer=None, device="cuda", request_streams: Optional[Callable] = None):
        self.sde = sde
        self.cfg = cfg or AdaptiveConfig()
        self.policy = resolve_policy(self.cfg.precision)
        self.params = params
        self.n = slots
        self.shape = tuple(sample_shape)
        self.device = resolve_device(device)
        if device_resident and request_streams is not None and self.device.type == "cuda":
            raise ValueError(
                "request_streams hands the carry Python callables, which the device-"
                "resident driver's CUDA graph cannot call: on the card it draws from "
                "SlotStreams only (the CPU's plain driver takes request_streams)")
        self.sync_horizon = int(sync_horizon)
        self.compaction = bool(compaction)
        self.device_resident = bool(device_resident)
        if solver != _family(self.cfg):
            raise ValueError(
                f"solver {solver!r} is not the family of the step's config "
                f"({_family(self.cfg)!r}: momentum {self.cfg.momentum}, probability_flow "
                f"{self.cfg.probability_flow}); the batcher runs the Algorithm-1 body only")
        #: score-net evaluations one loop iteration issues over the slots,
        #: from the solver registry
        self.nfe_per_iter = solver_nfe_per_iteration(solver, **(solver_kwargs or {}))
        self.tiered = bool(tolerance_classes)
        self.tolerance_classes = (tolerance_classes
                                  if isinstance(tolerance_classes, dict) else None)
        self.admission = admission if admission is not None else FifoAdmission()
        self.delivery = delivery if delivery is not None else TierAccounting()
        self._clock = clock if clock is not None else time.monotonic
        self.mesh = mesh
        #: under a mesh, the ``RowSharding`` of each carry leaf
        #: (``serving_loop_shardings``) and the slots' (the state's); None
        #: without one
        self._carry_shardings = self._sharding = None
        self.n_devices = 1
        if mesh is not None:
            from repro_torch.parallel.sharding import data_axes, serving_loop_shardings

            if mesh.device.type != self.device.type:
                raise ValueError(f"mesh on {mesh.device}, server on {self.device}")
            axes = data_axes(mesh)
            self.n_devices = math.prod(mesh.shape[a] for a in axes) if axes else 1
            if slots % self.n_devices:
                raise ValueError(f"slots={slots} must divide across {self.n_devices} devices")
            if (device_resident and self.device.type == "cuda"
                    and not ad.mesh_capturable(mesh.group())):
                raise ValueError(
                    "the device-resident driver under a mesh captures the mesh's "
                    "all-reduce into its CUDA graph, and gloo collectives cannot be "
                    "captured: serve device-resident on an NCCL mesh, or host-driven "
                    "on gloo")
            cond = (None if self.cfg.conditioner is None
                    else self.cfg.conditioner.cond_struct(slots, self.shape))
            self._carry_shardings, _ = serving_loop_shardings(
                mesh, slots, 1 + len(self.shape), cond=cond, tolerances=self.tiered,
                telemetry=int(telemetry) > 0)
            self._sharding = self._carry_shardings.x
            self._clock = MeshClock(self._clock, mesh)
        self.telemetry_capacity = int(telemetry)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = MetricsRegistry()
        self._c_iters = self.metrics.counter("serve_iterations_total")
        self._c_useful = self.metrics.counter("serve_nfe_useful_total")
        self._c_resident = self.metrics.counter("serve_nfe_resident_total")
        self._c_transfers = self.metrics.counter("serve_host_transfers_total")
        self._c_syncs = self.metrics.counter("serve_solver_syncs_total")
        self._c_accept = self.metrics.counter("serve_accepted_total")
        self._c_reject = self.metrics.counter("serve_rejected_total")
        if hasattr(self.delivery, "bind"):
            # the delivery stage's per-tier books share the serve loop's
            self.delivery.bind(self.metrics)
        self._streams = request_streams
        #: the tolerance a tier-less request rides: solve_chunk's rule
        self._default_atol = float(sde.abs_tolerance if self.cfg.eps_abs is None
                                   else self.cfg.eps_abs)
        self._default_rtol = float(self.cfg.eps_rel)
        self._default_h0 = min(float(self.cfg.h_init), sde.T - sde.t_eps)
        self.conditioner = self.cfg.conditioner
        self.sample_step = sample_step
        # no reference to self: a server (and its captured graph) is freed
        # as soon as its last user lets go of it
        self.step_fn = lambda p, c, h=self.sync_horizon, kw=self._shard_kw(): sample_step(
            p, c, max_sync_iters=h, **kw)
        #: one block of slots a data index of the mesh (one block without one)
        self.slots_per_device = slots // self.n_devices
        #: per-device count of queue→slot assignments (the initial fill
        #: included): admission proceeds block by block
        self.refills_per_device: List[int] = [0] * self.n_devices
        #: the slots this rank's carry holds: its block under a mesh
        rows = (range(slots) if self._sharding is None or self._sharding.replicated
                else range(slots)[self._sharding.rows])
        self._lo, self._hi = rows.start, rows.stop
        self.queue: Deque[ImageRequest] = deque()
        self.finished: Dict[int, ImageRequest] = {}
        self._slot_req: List[Optional[ImageRequest]] = [None] * slots
        #: driver windows (device-resident) / step() chunks (host-driven)
        self.horizon_windows = 0
        #: sync horizons the device-resident driver ran, over all windows
        self.device_horizons = 0
        #: units the device-resident driver ran, over all windows: body
        #: iterations (under a mesh, masked sync-horizon chunks, one a horizon)
        self.device_units = 0
        #: device-resident host visits: at an event (delivery pulls) and
        #: admission-only (newcomers into free slots, one pull)
        self.event_visits = 0
        self.admission_visits = 0
        #: host mirror of the carry's iteration counter (one read a chunk)
        self._host_iters = 0
        B, dev = self._hi - self._lo, self.device
        zi = lambda: torch.zeros((B,), dtype=torch.int32, device=dev)
        f32 = lambda v: torch.full((B,), v, dtype=torch.float32, device=dev)
        self._carry = SolverCarry(
            x=torch.zeros((B,) + self.shape, dtype=self.policy.state, device=dev),
            x_prev=torch.zeros((B,) + self.shape, dtype=self.policy.state, device=dev),
            t=f32(0.0),  # 0 = idle
            h=f32(self.cfg.h_init),
            nfe=zi(), accepted=zi(), rejected=zi(),
            done=torch.ones((B,), dtype=torch.bool, device=dev),
            iterations=torch.zeros((), dtype=torch.int32, device=dev),
            # idle slots draw from no request's stream
            generator=(SlotStreams(seed=torch.full((B,), -1, dtype=torch.int64, device=dev),
                                   counter=torch.zeros((B,), dtype=torch.int64, device=dev))
                       if request_streams is None else [None] * B),
            cond=(None if self.conditioner is None
                  else self._to_device(self.conditioner.neutral_cond(B, self.shape))),
            atol=f32(self._default_atol) if self.tiered else None,
            rtol=f32(self._default_rtol) if self.tiered else None,
            telemetry=(init_telemetry(B, self.telemetry_capacity, dev)
                       if self.telemetry_capacity > 0 else None),
        )
        #: the host's slot occupancy on the device, for the driver's event
        #: flag (idle slots ride with done=True); refreshed after each event
        self._occupied = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._driver: Optional[HorizonDriver] = None

    # ------------------------------------------------------------------
    def _shard_kw(self) -> dict:
        """The device step's keywords under a mesh: the slots' sharding."""
        return {} if self._sharding is None else {"sharding": self._sharding}

    def slot_device(self, slot: int) -> int:
        """The data index of the mesh that owns ``slot`` (contiguous blocks)."""
        return slot // self.slots_per_device

    def _local(self, slots) -> list:
        """This rank's carry rows of the global ``slots`` it owns."""
        return [i - self._lo for i in slots if self._lo <= i < self._hi]

    def _d2h(self, *tensors):
        """The serve loop's device→host seam: every read crosses here and
        is counted; one call is one logical sync, however many tensors
        ride in it. Returns numpy arrays (one, or a tuple)."""
        self._c_transfers.inc()
        out = tuple(t.cpu().numpy() for t in tensors)
        return out[0] if len(out) == 1 else out

    def _books(self, *vectors):
        """The (B,) bookkeeping read: every (B_local,) per-slot vector of the
        carry as the whole slot batch's, in one gather under a mesh; one
        ``_d2h`` read either way."""
        if self._sharding is not None:
            vectors = gather_slot_vectors(vectors, self.mesh, self._carry_shardings.done)
        return self._d2h(*vectors)

    def _to_device(self, cond: dict) -> dict:
        return {k: v.to(self.device) for k, v in cond.items()}

    def _request_cond(self, req: ImageRequest) -> dict:
        """An admitted request's condition rows: its own ``cond`` coerced
        to the payload's dtypes and shapes, or the conditioner's neutral
        payload (the null label for CFG, never class 0)."""
        if req.cond is None:
            return {k: v[0] for k, v in
                    self.conditioner.neutral_cond(1, self.shape).items()}
        struct = self.conditioner.cond_struct(1, self.shape)
        return {k: torch.as_tensor(np.asarray(req.cond[k])).to(s.dtype).reshape(s.shape[1:])
                for k, s in struct.items()}

    def _resolve_tier(self, tier) -> ToleranceClass:
        """Tier name or ToleranceClass → ToleranceClass, against this
        server's registry (or the presets)."""
        if isinstance(tier, ToleranceClass):
            return tier
        if self.tolerance_classes is not None:
            if tier in self.tolerance_classes:
                return self.tolerance_classes[tier]
            raise KeyError(f"unknown tolerance class {tier!r}; this server "
                           f"registers {sorted(self.tolerance_classes)}")
        return resolve_tier(tier)

    def _request_tol(self, req: ImageRequest):
        """An admitted request's (atol, rtol, h0): its class, None fields
        deferring to the config and SDE defaults."""
        if req.tier is None:
            return self._default_atol, self._default_rtol, self._default_h0
        tier = self._resolve_tier(req.tier)
        atol = self._default_atol if tier.eps_abs is None else float(tier.eps_abs)
        h = self.cfg.h_init if tier.h_init is None else tier.h_init
        return atol, float(tier.eps_rel), min(float(h), self.sde.T - self.sde.t_eps)

    def submit(self, req: ImageRequest) -> None:
        """Queue a request; it takes a slot at the next sync with a free
        one. Stamps the submission clock and settles the deadline and
        priority from the tolerance class."""
        if req.tier is not None and not self.tiered:
            raise ValueError(
                f"request {req.uid} carries tier {req.tier!r} but this server was "
                "built without tolerance_classes: its carry has no per-slot "
                "tolerance leaves to honour it")
        now = self._clock()
        req._submit_t = now
        tier = None if req.tier is None else self._resolve_tier(req.tier)
        if req.priority is None:
            req.priority = 0 if tier is None else int(tier.priority)
        deadline_ms = req.deadline_ms
        if deadline_ms is None and tier is not None:
            deadline_ms = tier.deadline_ms
        req.deadline_at = None if deadline_ms is None else now + deadline_ms / 1000.0
        self.queue.append(req)

    # -- serve-loop counters (DESIGN.md §15), read from the registry -----
    @property
    def total_iterations(self) -> int:
        """Loop iterations run (each costs nfe_per_iter forwards over all
        slots, busy or not)."""
        return int(self._c_iters.value)

    @property
    def useful_nfe(self) -> int:
        """Σ per-request NFE delivered."""
        return int(self._c_useful.value)

    @property
    def resident_nfe(self) -> int:
        """Σ nfe_per_iter·resident_iters over delivered requests."""
        return int(self._c_resident.value)

    @property
    def host_transfers(self) -> int:
        """Device→host reads the serve loop issued (through ``_d2h``)."""
        return int(self._c_transfers.value)

    @property
    def solver_syncs(self) -> int:
        """Host syncs inside the device step (``adaptive.sync_state``),
        apart from ``host_transfers``; the reference's jitted chunk has
        none."""
        return int(self._c_syncs.value)

    @property
    def graph_captures(self) -> int:
        """Horizon graphs this server captured: one on the card once the
        device-resident driver has run, else 0."""
        return 0 if self._driver is None else self._driver.captures

    @property
    def class_stats(self) -> Dict[str, Any]:
        """Per-class delivery counters (DESIGN.md §14) as plain dicts."""
        return {name: s.as_dict() for name, s in self.delivery.stats.items()}

    @property
    def wasted_nfe_fraction(self) -> float:
        """Share of issued evaluations (nfe_per_iter · slots · iterations)
        spent on idle or converged slots; 0 before any ran."""
        issued = self.nfe_per_iter * self.n * self.total_iterations
        if issued == 0:
            return 0.0
        return 1.0 - min(self.useful_nfe, issued) / issued

    @property
    def passenger_nfe_fraction(self) -> float:
        """Share of evaluations issued to occupied slots whose sample had
        already converged: the waste only compaction removes. 0 before
        any delivery."""
        if self.resident_nfe == 0:
            return 0.0
        return 1.0 - min(self.useful_nfe, self.resident_nfe) / self.resident_nfe

    # ------------------------------------------------------------------
    def _retire(self, rows, nfe, acc, rej, conv_idx) -> None:
        """Deliver the transferred retired rows: fill in each request, move
        it to ``finished``, free its slot, charge the books."""
        now = self._clock()
        with self.tracer.span("serve/delivery",
                              uids=[self._slot_req[i].uid for i in conv_idx],
                              slots=list(conv_idx),
                              nfe=[int(nfe[i]) for i in conv_idx]):
            for row, i in zip(rows, conv_idx):
                req = self._slot_req[i]
                req.result = row
                req.nfe = int(nfe[i])
                req.accepted = int(acc[i])
                req.rejected = int(rej[i])
                req.done = True
                req.resident_iters = self.total_iterations - req._admit_iters
                self.finished[req.uid] = req
                self._c_useful.inc(int(nfe[i]))
                self._c_resident.inc(self.nfe_per_iter * req.resident_iters)
                self._c_accept.inc(int(acc[i]))
                self._c_reject.inc(int(rej[i]))
                self._slot_req[i] = None
                self.delivery.on_deliver(req, now)

    def _admit_from_queue(self):
        """Seat queued requests in free slots, lowest free slot first
        (host bookkeeping; the caller writes the carry). Returns the
        admitted (slots, requests)."""
        free = [i for i in range(self.n) if self._slot_req[i] is None]
        if not free or not self.queue:
            return [], []
        now = self._clock()
        with self.tracer.span("serve/admission", free=len(free),
                              queued=len(self.queue)) as sp:
            reqs = self.admission.select(self.queue, len(free), now)
            admit_pos = free[: len(reqs)]
            for i, req in zip(admit_pos, reqs):
                self._slot_req[i] = req
                req._admit_iters = self.total_iterations
                req._seat_t = now
                self.refills_per_device[self.slot_device(i)] += 1
            # the span names the uids seated and the slots they took
            sp["attrs"]["uids"] = [r.uid for r in reqs]
            sp["attrs"]["slots"] = list(admit_pos)
        return admit_pos, reqs

    def _compaction_perm(self) -> np.ndarray:
        """Shard-local compaction: within each device's block of slots, pack
        the in-flight samples to the front (no slot crosses a block), and
        reorder ``_slot_req`` to match; the identity when compaction is
        off."""
        perm = np.arange(self.n)
        if self.compaction:
            for d in range(self.n_devices):
                block = range(d * self.slots_per_device, (d + 1) * self.slots_per_device)
                live = [i for i in block if self._slot_req[i] is not None]
                free = [i for i in block if self._slot_req[i] is None]
                perm[block.start:block.stop] = live + free
            self._slot_req = [self._slot_req[j] for j in perm]
        return perm

    def _sync(self) -> None:
        """Host sync: retire converged slots, compact, admit from the queue.

        Only the (B,) bookkeeping and the retired rows cross to the host;
        the permutation and the admissions are applied on the device.
        """
        c = self._carry
        # the device's own convergence mask: anything else could disagree
        # with the loop's active mask and make retirement depend on the
        # sync horizon
        done, nfe, acc, rej = self._books(c.done, c.nfe, c.accepted, c.rejected)
        occupied = [r is not None for r in self._slot_req]
        conv = [occupied[i] and bool(done[i]) for i in range(self.n)]
        if not self.compaction and occupied != conv and any(occupied):
            return  # monolithic wave: turn over once every slot converged
        if not any(conv) and not (self.queue and not all(occupied)):
            return

        # 1. deliver the converged slots (the t_eps state, before the
        #    Tweedie denoise, as the reference delivers)
        conv_idx = [i for i in range(self.n) if conv[i]]
        if conv_idx:
            self._retire(self._d2h(self._retired_rows(conv_idx)), nfe, acc, rej, conv_idx)
        # 2. compaction (each sample's stream moves with it) and 3. admission
        perm = self._compaction_perm()
        admit_pos, reqs = self._admit_from_queue()
        self._write_slots(perm, admit_pos, reqs)
        # the counter is per chunk in serving: folded into the host total
        # and reset, so cfg.max_iters never trips on a long run
        c.iterations.zero_()
        self._host_iters = 0

    def _retired_rows(self, conv_idx) -> Tensor:
        """The converged slots' rows in fp32, with the conditioner's exact
        ``finalize_project`` (inpainting pins the observed coordinates).
        Under a mesh each rank cuts the rows it owns and one gather hands
        every rank all of them, in ``conv_idx``'s (ascending) order."""
        c = self._carry
        idx = torch.tensor(self._local(conv_idx), dtype=torch.long, device=self.device)
        rows = c.x.index_select(0, idx).to(torch.float32)
        if self.conditioner is not None:
            cond_rows = {k: v.index_select(0, idx) for k, v in c.cond.items()}
            rows = self.conditioner.finalize_project(rows, cond_rows)
        if self._sharding is not None:
            counts = [sum(1 for i in conv_idx if self.slot_device(i) == d)
                      for d in range(self.n_devices)]
            rows = gather_retired(rows, counts, self.mesh, self._sharding)
        return rows

    def _write_slots(self, perm: np.ndarray, admit_pos, reqs) -> None:
        """Apply one host decision to the carry in place: permute every
        per-slot leaf by ``perm`` (the telemetry rows too; the ring is never
        cleared at admission, DESIGN.md §15), then write the admitted
        requests' rows: the prior at t = T (each request's stream at
        counter 0), h0 or the tier's h, zeroed counts, the tier's
        atol/rtol, the condition payload, and the stream itself from
        counter 1. The device-resident driver's graph reads these same
        buffers, so nothing is rebound."""
        c, dev = self._carry, self.device
        # this rank's block: compaction never leaves a block, so the block's
        # permutation is its own rows'
        perm = perm[self._lo:self._hi] - self._lo
        permute = not np.array_equal(perm, np.arange(perm.shape[0]))
        if permute:
            perm_t = torch.from_numpy(perm).to(dev)
            for leaf in self._slot_leaves():
                leaf.copy_(leaf.index_select(0, perm_t))
            if isinstance(c.generator, list):
                c.generator = [c.generator[j] for j in perm]
        reqs = [r for i, r in zip(admit_pos, reqs) if self._lo <= i < self._hi]
        admit_pos = self._local(admit_pos)
        if not admit_pos:
            return
        k = len(admit_pos)
        pos_t = torch.tensor(admit_pos, dtype=torch.long, device=dev)
        put = lambda leaf, v: leaf.index_copy_(
            0, pos_t, v.to(leaf.dtype) if isinstance(v, Tensor)
            else torch.full((k,), v, dtype=leaf.dtype, device=dev))
        if isinstance(c.generator, SlotStreams):
            seeds = torch.tensor([int(r.seed) for r in reqs], dtype=torch.int64, device=dev)
            priors = self.sde.prior_sample((k,) + self.shape,
                                           SlotStreams(seed=seeds, counter=torch.zeros_like(seeds)))
            put(c.generator.seed, seeds)
            put(c.generator.counter, 1)
        else:
            drawn = [self._streams(req, self.shape, dev) for req in reqs]
            priors = torch.stack([p for p, _ in drawn]).to(dev)
            for i, (_, src) in zip(admit_pos, drawn):
                c.generator[i] = src
        put(c.x, priors)
        put(c.x_prev, priors)
        put(c.t, float(self.sde.T))
        for leaf in (c.nfe, c.accepted, c.rejected):
            put(leaf, 0)
        put(c.done, False)
        if self.tiered:
            tols = np.asarray([self._request_tol(r) for r in reqs], np.float32).T
            for leaf, v in zip((c.atol, c.rtol, c.h), tols):
                put(leaf, torch.from_numpy(np.ascontiguousarray(v)).to(dev))
        else:
            put(c.h, self._default_h0)
        if c.cond is not None:
            rows = [self._request_cond(r) for r in reqs]
            for name, leaf in c.cond.items():
                put(leaf, torch.stack([r[name] for r in rows]).to(dev))

    def _slot_leaves(self) -> List[Tensor]:
        """Every (B, ...) tensor of the carry that moves with its slot."""
        c = self._carry
        leaves = [c.x, c.x_prev, c.t, c.h, c.nfe, c.accepted, c.rejected, c.done]
        if isinstance(c.generator, SlotStreams):
            leaves += [c.generator.seed, c.generator.counter]
        if c.atol is not None:
            leaves += [c.atol, c.rtol]
        if c.cond is not None:
            leaves += list(c.cond.values())
        if c.telemetry is not None:
            tel = c.telemetry
            leaves += [tel.t, tel.h, tel.err, tel.accept]
        return leaves

    # ------------------------------------------------------------------
    def _set_occupied(self) -> None:
        """Mirror the host's slot occupancy into the device mask the
        driver's event flag reads (one host→device copy)."""
        self._occupied.copy_(torch.tensor([r is not None for r in
                                           self._slot_req[self._lo:self._hi]]))

    def _device_driver(self) -> HorizonDriver:
        """The device-resident driver, built at the first window: on the
        card it captures its unit over the carry's buffers (once per
        server; one iteration, under a mesh the masked sync-horizon chunk)
        and builds the WHILE-node graph around it."""
        if self._driver is None:
            h, flags = self.sync_horizon, None
            if self._sharding is not None:
                flags = ad.MeshFlags(self._sharding, self._occupied, horizon=h,
                                     draws=ad.draws_per_iteration(self.cfg))
            unit, horizon = self.sample_step.horizon_unit(self.params, h, self.device,
                                                          flags=flags, **self._shard_kw())
            self._driver = HorizonDriver(self._carry, self._occupied, unit,
                                         max_horizons=MAX_HORIZONS, horizon=horizon,
                                         max_iters=self.cfg.max_iters,
                                         wait_all=not self.compaction, flags=flags)
            self._carry = self._driver.carry
        return self._driver

    def _process_events(self, deliver: bool = True) -> None:
        """Device-resident event handler (DESIGN.md §12): one host visit
        that retires, compacts and admits, written into the carry's
        buffers in place.

        ``deliver=False`` is the admission-only form (newcomers into
        already-free slots: nothing to deliver, so only the iteration
        counter is pulled). Every read goes through ``_d2h``: one
        bookkeeping pull, plus one pull of the retired rows when something
        converged — O(events), never O(horizons)."""
        c = self._carry
        if deliver:
            self.event_visits += 1
            # the iteration count is the mesh's (replicated): it rides the
            # gather as a vector
            done, nfe, acc, rej, iters = self._books(
                c.done, c.nfe, c.accepted, c.rejected, c.iterations.expand(c.batch))
            iters = iters[0]
        else:
            self.admission_visits += 1
            iters = self._d2h(c.iterations)
            done, acc, rej, nfe = np.zeros(self.n, bool), None, None, None
        # fold-and-reset: the device counter restarts at every host visit
        self._c_iters.inc(int(iters))
        self._host_iters = 0
        conv_idx = [i for i, r in enumerate(self._slot_req) if r is not None and bool(done[i])]
        if conv_idx:
            self._retire(self._d2h(self._retired_rows(conv_idx)), nfe, acc, rej, conv_idx)
        perm = self._compaction_perm()
        can_admit = self.compaction or not any(r is not None for r in self._slot_req)
        admit_pos, reqs = self._admit_from_queue() if can_admit else ([], [])
        self._write_slots(perm, admit_pos, reqs)
        c.iterations.zero_()
        self._set_occupied()

    def _device_step(self) -> int:
        """One device-resident window: at most MAX_HORIZONS · sync_horizon
        iterations a host visit, one read of the driver's state (the event
        flag, the horizons and the units run)."""
        occupied = [r is not None for r in self._slot_req]
        if self.queue and not all(occupied) and (self.compaction or not any(occupied)):
            # admission is host knowledge (queue and occupancy): seat the
            # newcomers before the window; no slot frees up inside it
            self._process_events(deliver=False)
        busy = sum(1 for r in self._slot_req if r is not None)
        if busy == 0:
            return 0
        ann = (profiler_annotation("serve/solve", step=self.horizon_windows,
                                   device=self.device)
               if self.tracer.enabled else contextlib.nullcontext())
        with self.tracer.span("serve/solve", window=self.horizon_windows,
                              busy=busy), ann:
            driver = self._device_driver()
            syncs = ad.host_syncs
            state = driver.window()
            event, horizons, _, units = self._d2h(state)
            self._c_syncs.inc(ad.host_syncs - syncs)
        self.horizon_windows += 1
        self.device_horizons += int(horizons)
        self.device_units += int(units)
        driver.account(int(units))
        if event:
            self._process_events()
        return busy

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One serve-loop turn; returns the busy slots that entered the
        device work. Host-driven: one sync-horizon chunk. Device-resident:
        one driver window."""
        if self.device_resident:
            return self._device_step()
        self._sync()
        busy = sum(1 for r in self._slot_req if r is not None)
        if busy == 0:
            return 0
        ann = (profiler_annotation("serve/solve", step=self.horizon_windows,
                                   device=self.device)
               if self.tracer.enabled else contextlib.nullcontext())
        with self.tracer.span("serve/solve", window=self.horizon_windows,
                              busy=busy), ann:
            syncs = ad.host_syncs
            self._carry = self.step_fn(self.params, self._carry)
            self._c_syncs.inc(ad.host_syncs - syncs)
            cur = int(self._d2h(self._carry.iterations))
        self.horizon_windows += 1
        self._c_iters.inc(cur - self._host_iters)
        self._host_iters = cur
        return busy

    def run_to_completion(self, max_steps: int = 100_000) -> Dict[int, ImageRequest]:
        """Drain the queue: step until every submitted request is delivered."""
        steps = 0
        while (self.queue or any(r is not None for r in self._slot_req)) \
                and steps < max_steps:
            if self.step() == 0 and not self.queue:
                break
            steps += 1
        # deliver the stragglers
        if self.device_resident:
            self._process_events()
        else:
            self._sync()
        return self.finished

    # ------------------------------------------------------------------
    def metrics_snapshot(self) -> MetricsRegistry:
        """Refresh the point-in-time gauges (queue depth, occupancy, waste
        fractions, acceptance rate) and return the registry."""
        m = self.metrics
        m.gauge("serve_queue_depth").set(float(len(self.queue)))
        m.gauge("serve_slots_occupied").set(
            float(sum(1 for r in self._slot_req if r is not None)))
        m.gauge("serve_slots_total").set(float(self.n))
        m.gauge("serve_wasted_nfe_fraction").set(self.wasted_nfe_fraction)
        m.gauge("serve_passenger_nfe_fraction").set(self.passenger_nfe_fraction)
        acc, rej = self._c_accept.value, self._c_reject.value
        m.gauge("serve_acceptance_rate").set(acc / (acc + rej) if (acc + rej) else 0.0)
        m.gauge("serve_horizon_windows").set(float(self.horizon_windows))
        return m

    def trace_record(self) -> Dict[str, Any]:
        """One JSON-ready record of what the server observed: delivered
        requests with their books, the registry, the tracer's spans and
        histograms, the per-class stats and, with the ring on, the
        chronological step history (``repro_torch.analysis.telemetry``
        renders it). Under a mesh the ring's rows are gathered from every
        rank: a collective, which every rank calls."""
        self.metrics_snapshot()
        requests = [
            {"uid": r.uid, "tier": tier_name(r), "nfe": r.nfe,
             "accepted": r.accepted, "rejected": r.rejected,
             "resident_iters": r.resident_iters,
             "deadline_missed": bool(r.deadline_missed)}
            for r in sorted(self.finished.values(), key=lambda r: r.uid)
        ]
        rec: Dict[str, Any] = {
            "requests": requests,
            "metrics": self.metrics.to_json(),
            "trace": self.tracer.to_json(),
            "class_stats": self.class_stats,
        }
        tel = self._carry.telemetry
        if tel is not None:
            rings = [getattr(tel, f) for f in ("t", "h", "err", "accept")]
            if self._sharding is not None:
                rings = [gather_rows(r, self.mesh, self._carry_shardings.telemetry.t)
                         for r in rings]
            t, h, err, accept, head = self._d2h(*rings, tel.head)
            hist = telemetry_history(dataclasses.replace(
                tel, t=t, h=h, err=err, accept=accept, head=head))
            rec["telemetry"] = {
                "t": hist["t"].tolist(), "h": hist["h"].tolist(),
                "err": hist["err"].tolist(),
                "accept": hist["accept"].astype(int).tolist(),
                "iterations": int(hist["iterations"]),
                "records": int(hist["records"]),
                "t_eps": float(self.sde.t_eps),
            }
        return rec
