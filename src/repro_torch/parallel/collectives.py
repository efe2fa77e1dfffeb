"""Collectives of the data-parallel sampling and serving paths; port of
``scaled_error_l2_psum`` from ``repro/parallel/collectives.py``, plus what
the reference leaves to XLA: the O(1) loop-control reduction
(``all_max``, also the device-resident driver's event flags), the row
gather, and the serve loop's two gathers at a sync: the (B_local,)
bookkeeping vectors into (B,) (``gather_slot_vectors``) and the retired
rows to every rank (``gather_retired``).

Every collective runs over a group of the port's ``Mesh``
(``torch.distributed``: NCCL on the card, gloo on the CPU).
``flash_decode`` waits for the LM under a mesh (ROADMAP A11, the LM half).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def scaled_error_l2_psum(sq_sum: Tensor, n_local, group) -> Tensor:
    """Cross-rank combine of the solver's scaled ℓ2 error (DESIGN.md §3).

    Each rank holds the per-sample sums of squared scaled residuals
    ``sq_sum`` (B_local,) over its ``n_local`` feature columns; the
    dimension-normalised error over all ranks of ``group`` is

        E₂ = sqrt( Σ sq_sum / Σ n )

    One ``all_reduce(SUM)`` of a (B_local + 1,) fp32 tensor (the sums and
    the count) carries both sums: O(B) traffic. The reduction order is
    the backend's, the same on every rank of the group.
    """
    n = torch.full((1,), float(n_local), dtype=torch.float32, device=sq_sum.device)
    buf = torch.cat([sq_sum.to(torch.float32), n])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return torch.sqrt(buf[:-1] / buf[-1])


def all_max(t: Tensor, group) -> Tensor:
    """Element-wise maximum of ``t`` over ``group``, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def _shard_owners(mesh: Mesh, sharding) -> list:
    """The global rank holding each shard of ``sharding``, in shard order:
    shards are indexed by the data axes, major to minor, and ranks on
    other axes hold copies (the first one is taken)."""
    ranks = np.asarray(mesh.ranks())
    owner = {}
    for pos in itertools.product(*(range(n) for n in mesh.sizes)):
        shard = 0
        for a in sharding.axes:
            i = mesh.axis_names.index(a)
            shard = shard * mesh.sizes[i] + pos[i]
        owner.setdefault(shard, int(ranks[pos]))
    return [owner[s] for s in range(sharding.n_shards)]


def gather_rows(t: Tensor, mesh: Mesh, sharding) -> Tensor:
    """The global (B, ...) tensor from every rank's rows ``t``.

    ``sharding`` is the ``RowSharding`` the rows were cut by. A replicated
    leaf is returned as it is; otherwise one ``all_gather`` over the whole
    mesh collects every rank's rows, and the shards are put in order by
    each rank's index over the data axes.
    """
    if sharding.replicated:
        return t
    group = mesh.group()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat([parts[r] for r in _shard_owners(mesh, sharding)])


def gather_slot_vectors(vectors, mesh: Mesh, sharding) -> list:
    """Every rank's (B_local,) integer or bool vectors as (B,) vectors, in
    one ``all_gather``: the serve loop's bookkeeping read at a sync.

    The vectors are stacked as int64 (which holds every int32 and bool
    exactly), gathered, and each comes back in its own dtype.
    """
    if sharding.replicated:
        return list(vectors)
    packed = torch.stack([v.to(torch.int64) for v in vectors])
    full = gather_rows(packed.t().contiguous(), mesh, sharding).t()
    return [row.to(v.dtype) for row, v in zip(full, vectors)]


def gather_retired(rows: Tensor, counts, mesh: Mesh, sharding) -> Tensor:
    """The retired rows of every rank, on every rank, in one
    ``all_gather``: shard s contributes its ``counts[s]`` rows (this rank's
    are ``rows``), and the result is the shards' rows in shard order.

    Every rank knows ``counts`` from the gathered bookkeeping, so the
    blocks are padded to the largest count and cut after the gather.
    """
    if sharding.replicated:
        return rows
    pad = max(counts)
    block = rows.new_zeros((pad,) + tuple(rows.shape[1:]))
    block[: rows.shape[0]] = rows
    group = mesh.group()
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, block, group=group)
    owners = _shard_owners(mesh, sharding)
    return torch.cat([parts[owners[s]][:k] for s, k in enumerate(counts)])
