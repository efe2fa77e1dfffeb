"""Collectives of the data-parallel sampling path; port of
``scaled_error_l2_psum`` from ``repro/parallel/collectives.py``, plus the
O(1) loop-control reduction and the row gather that the reference leaves
to XLA.

Every collective runs over a group of the port's ``Mesh``
(``torch.distributed``: NCCL on the card, gloo on the CPU).
``flash_decode`` waits for the LM under a mesh (ROADMAP A11).
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


def gather_rows(t: Tensor, mesh: Mesh, sharding) -> Tensor:
    """The global (B, ...) tensor from every rank's rows ``t``.

    ``sharding`` is the ``RowSharding`` the rows were cut by. A replicated
    leaf is returned as it is; otherwise one ``all_gather`` over the whole
    mesh collects every rank's rows, and the shards are put in order by
    each rank's index over the data axes (ranks on other axes hold copies).
    """
    if sharding.replicated:
        return t
    group = mesh.group()
    world = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    # the rank at each mesh position, and the shard its rows are
    ranks = np.asarray(mesh.ranks())
    owner = {}
    for pos in itertools.product(*(range(n) for n in mesh.sizes)):
        shard = 0
        for a in sharding.axes:
            i = mesh.axis_names.index(a)
            shard = shard * mesh.sizes[i] + pos[i]
        owner.setdefault(shard, int(ranks[pos]))
    return torch.cat([parts[owner[s]] for s in range(sharding.n_shards)])
