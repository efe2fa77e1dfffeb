"""Sharding rules for data-parallel sampling; port of the sampling half of
``repro/parallel/sharding.py`` (``data_axes``, ``batch_sharding``,
``replicated``, ``sample_state_shardings``, ``solver_carry_shardings``).

In the reference a sharding is a ``NamedSharding``: it says how XLA lays
one global array over the mesh. In the port each rank holds only its own
rows, so a sharding here says which rows of a (B, ...) or (B,) leaf this
rank owns: a contiguous range when the batch divides the mesh's data
axes, every row otherwise (the reference then replicates). The rows of
shard i are [i·B/n, (i+1)·B/n), with i this rank's index over the data
axes, major to minor, which is where the reference's ``PartitionSpec``
puts them.

Not ported yet, each with the slice that needs it (ROADMAP): the
per-slot key leaf and the telemetry ring of ``solver_carry_shardings``
(A7, A9); ``param_shardings``, ``kv_cache_spec``/``kv_cache_sharding``
and ``serving_loop_shardings`` (A11, A7).
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
                           cond=None, tolerances: bool = False):
    """A ``SolverCarry`` whose leaves are the ``RowSharding`` of each leaf
    of the carry (DESIGN.md §7).

    ``cond`` is the condition payload (a dict of tensors, each leading
    with the batch); each leaf gets a batch sharding of its own ndim, so
    a slot's condition lives with the slot. ``tolerances`` gives the
    per-sample ``atol``/``rtol`` the (B,) vector sharding; False matches
    a carry with no tolerance leaves. The generator replicates: every
    rank draws the whole batch's noise and keeps its rows.
    """
    from repro_torch.core.solvers.adaptive import SolverCarry

    arr, vec, rep = sample_state_shardings(mesh, batch, state_ndim)
    cond_s = ({k: batch_sharding(mesh, batch, v.ndim) for k, v in cond.items()}
              if cond is not None else None)
    tol = vec if tolerances else None
    return SolverCarry(x=arr, x_prev=arr, t=vec, h=vec, nfe=vec, accepted=vec,
                       rejected=vec, done=vec, iterations=rep, generator=rep,
                       atol=tol, rtol=tol, cond=cond_s)
