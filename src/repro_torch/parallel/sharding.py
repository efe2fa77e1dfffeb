"""Sharding rules for data-parallel sampling and serving; port of the
diffusion half of ``repro/parallel/sharding.py`` (``data_axes``,
``batch_sharding``, ``replicated``, ``sample_state_shardings``,
``solver_carry_shardings``, ``serving_loop_shardings``).

In the reference a sharding is a ``NamedSharding``: it says how XLA lays
one global array over the mesh. In the port each rank holds only its own
rows, so a sharding here says which rows of a (B, ...) or (B,) leaf this
rank owns: a contiguous range when the batch divides the mesh's data
axes, every row otherwise (the reference then replicates). The rows of
shard i are [i·B/n, (i+1)·B/n), with i this rank's index over the data
axes, major to minor, which is where the reference's ``PartitionSpec``
puts them.

The LM's rules, ``param_shardings`` and ``kv_cache_spec``/
``kv_cache_sharding``, are not ported yet (ROADMAP A11, the LM half).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch axes present in this mesh: ("pod", "data") or ("data",)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


@dataclasses.dataclass(frozen=True, eq=False)
class RowSharding:
    """The rows of a (``batch``, ...) leaf of ``ndim`` dimensions that this
    rank of ``mesh`` owns: ``rows``, sharded over ``axes`` (empty when
    every rank holds every row). ``batch`` None means the leaf has no
    batch axis (a replicated scalar)."""

    mesh: Mesh
    axes: Tuple[str, ...]
    batch: Optional[int]
    ndim: int

    @property
    def n_shards(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    @property
    def shard(self) -> int:
        """This rank's shard index over ``axes`` (0 when replicated)."""
        return self.mesh.index(self.axes)

    @property
    def replicated(self) -> bool:
        return not self.axes

    @property
    def rows(self) -> slice:
        if self.batch is None:
            return slice(None)
        n = self.batch // self.n_shards
        return slice(self.shard * n, (self.shard + 1) * n)

    @property
    def spec(self) -> tuple:
        """The reference's ``PartitionSpec`` as a tuple: the batch axes (or
        None) first, None for every other dimension."""
        return ((self.axes or None),) + (None,) * (self.ndim - 1) if self.ndim else ()

    def local(self, t: Tensor) -> Tensor:
        """This rank's rows of the global leaf ``t`` (a view)."""
        if self.batch is not None and t.shape[0] != self.batch:
            raise ValueError(f"leaf batch {t.shape[0]} != sharding batch {self.batch}")
        return t[self.rows]

    def global_shape(self, local_shape) -> tuple:
        """The global shape of a leaf whose local rows have ``local_shape``."""
        return (self.batch, *tuple(local_shape)[1:])

    def with_ndim(self, ndim: int) -> "RowSharding":
        return dataclasses.replace(self, ndim=ndim)


def batch_sharding(mesh: Mesh, batch: int, ndim: int) -> RowSharding:
    """Shard the leading batch dim over ("pod", "data") when divisible."""
    axes = data_axes(mesh)
    total = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if axes and batch % total == 0:
        return RowSharding(mesh, axes, batch, ndim)
    return RowSharding(mesh, (), batch, ndim)


def replicated(mesh: Mesh) -> RowSharding:
    """Every rank holds the whole leaf (the PRNG generator, loop counters)."""
    return RowSharding(mesh, (), None, 0)


def sample_state_shardings(mesh: Mesh, batch: int, state_ndim: int):
    """Shardings for the adaptive-sampling carry (DESIGN.md §3).

    Returns ``(array, vector, replicated)``: ``array`` for (B, ...) state
    tensors (x, x'_prev, noise), ``vector`` for per-sample (B,) values
    (t, h, nfe, the accept/reject counters, done), ``replicated`` for the
    generator and loop counters. The batch shards over the mesh's data
    axes when divisible; otherwise everything replicates, so the caller
    never has to special-case indivisible batches.
    """
    arr = batch_sharding(mesh, batch, state_ndim)
    return arr, arr.with_ndim(1), replicated(mesh)


def solver_carry_shardings(mesh: Mesh, batch: int, state_ndim: int, *,
                           per_slot_keys: bool = False, cond=None,
                           tolerances: bool = False, telemetry: bool = False):
    """A ``SolverCarry`` whose leaves are the ``RowSharding`` of each leaf
    of the carry (DESIGN.md §7).

    ``per_slot_keys`` shards the noise source with the state: the
    carry's ``generator`` is then a ``SlotStreams`` (or a list of per-slot
    sources) whose seed and counter rows are this rank's rows, and each
    rank draws its own rows (P1 draws by (seed, counter), so no rank
    needs another's streams, and shard-local compaction never moves a
    stream across ranks). Without it the generator replicates: every
    rank draws the whole batch's noise and keeps its rows.

    ``cond`` is the condition payload (a dict of tensors, each leading
    with the batch); each leaf gets a batch sharding of its own ndim, so
    a slot's condition lives with the slot. ``tolerances`` gives the
    per-sample ``atol``/``rtol`` the (B,) vector sharding; False matches
    a carry with no tolerance leaves. ``telemetry`` shards the
    step-telemetry ring's (B, cap) buffers by rows and replicates its
    head cursor; False matches a carry without a ring.
    """
    from repro_torch.core.solvers.adaptive import SolverCarry
    from repro_torch.observability.telemetry import StepTelemetry

    arr, vec, rep = sample_state_shardings(mesh, batch, state_ndim)
    cond_s = ({k: batch_sharding(mesh, batch, v.ndim) for k, v in cond.items()}
              if cond is not None else None)
    tol = vec if tolerances else None
    tel = None
    if telemetry:
        ring = batch_sharding(mesh, batch, 2)
        tel = StepTelemetry(t=ring, h=ring, err=ring, accept=ring, head=rep)
    return SolverCarry(x=arr, x_prev=arr, t=vec, h=vec, nfe=vec, accepted=vec,
                       rejected=vec, done=vec, iterations=rep,
                       generator=vec if per_slot_keys else rep,
                       atol=tol, rtol=tol, cond=cond_s, telemetry=tel)


def serving_loop_shardings(mesh: Mesh, batch: int, state_ndim: int, *,
                           per_slot_keys: bool = True, cond=None,
                           tolerances: bool = False, telemetry: bool = False):
    """The sharding pair of the serve loop under a mesh (DESIGN.md §12):
    ``(carry_shardings, scalar_sharding)``.

    In the reference the pair pins the jitted driver's outputs to the
    carry's input shardings, so that XLA keeps the donated buffers. The
    port has no donation to pin: each rank's carry is its static block
    of rows, written in place by the host's event updates and, on the
    card, read and written by the captured horizon graph
    (``solver_carry_shardings``, ``per_slot_keys`` on). The scalar
    sharding (replicated) covers the driver's event state and the global
    flags the ranks agree on after every horizon.
    """
    carry = solver_carry_shardings(mesh, batch, state_ndim, per_slot_keys=per_slot_keys,
                                   cond=cond, tolerances=tolerances, telemetry=telemetry)
    return carry, replicated(mesh)
