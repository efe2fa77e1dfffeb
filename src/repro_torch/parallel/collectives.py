"""Collectives; port of ``repro/parallel/collectives.py``
(``scaled_error_l2_psum``, ``flash_decode``), plus what the reference
leaves to XLA: for sampling and serving, the O(1) loop-control reduction
(``all_max``, also the device-resident driver's event flags), the row
gather, and the serve loop's two gathers at a sync: the (B_local,)
bookkeeping vectors into (B,) (``gather_slot_vectors``) and the retired
rows to every rank (``gather_retired``); for the language models under
a mesh, the collectives GSPMD inserts for the reference: the sum of
partial products over an axis (``all_reduce_sum``), the gather of a
dimension (``all_gather_dim``) and the reduce-scatter of a dimension
(``reduce_scatter_dim``).

Every collective runs over a group of the port's ``Mesh``
(``torch.distributed``: NCCL on the card, gloo on the CPU, or gloo on the
card with two ranks on one card). The LM's collectives run forward only
and return their result (the caller never reads its input again), so
that a training path can wrap them in ``torch.autograd.Function``s
without changing the callers. ``calls`` and ``nbytes`` count the LM's
collectives and the bytes each rank sends into them.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.sharding import lever_axes

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


# --------------------------------------------------------------------------
# the language models' collectives
# --------------------------------------------------------------------------

#: the LM collectives called and the bytes this rank put into them, since
#: they were last set to 0
calls = 0
nbytes = 0


def _count(t: Tensor) -> None:
    global calls, nbytes
    calls += 1
    nbytes += t.numel() * t.element_size()


def axes_group(mesh: Mesh, axes: Sequence[str]):
    """The process group spanning ``axes`` of ``mesh``: one axis's group,
    or the whole mesh's when ``axes`` are all of its axes."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.group(axes[0])
    if set(axes) == set(mesh.axis_names):
        return mesh.group()
    raise ValueError(f"no process group for axes {axes} of a mesh over {mesh.axis_names}")


def axes_size(mesh: Mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def all_reduce_sum(t: Tensor, mesh: Mesh, axis: str = "model") -> Tensor:
    """The sum of every rank's ``t`` over ``axis`` (every rank gets the same
    bits). A one-rank axis returns ``t``."""
    if mesh.shape[axis] == 1:
        return t
    t = t.contiguous()
    _count(t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return t


def all_gather_dim(t: Tensor, dim: int, mesh: Mesh, axes: Union[str, Sequence[str]] = "model"
                   ) -> Tensor:
    """Every rank's ``t`` over ``axes``, concatenated along ``dim`` in the
    ranks' order over ``axes`` (major to minor). A one-rank span returns
    ``t``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = axes_size(mesh, axes)
    if n == 1:
        return t
    group = axes_group(mesh, axes)
    t = t.contiguous()
    _count(t)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    # group rank i sits at mesh index i over these axes (row-major mesh)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(t: Tensor, dim: int, mesh: Mesh, axis: str = "model") -> Tensor:
    """This rank's block (of ``n`` equal blocks along ``dim``) of the sum of
    every rank's ``t`` over ``axis``. NCCL reduce-scatters; gloo, which
    cannot, all-reduces and keeps the rank's block (the same numbers)."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over {n} ranks of {axis!r}")
    i, b = mesh.coord(axis), size // n
    group = mesh.group(axis)
    if dist.get_backend(group) == "nccl":
        parts = [p.contiguous() for p in t.split(b, dim=dim)]
        out = torch.empty_like(parts[0])
        _count(t)
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
        return out
    return all_reduce_sum(t, mesh, axis).narrow(dim, i * b, b)


def flash_decode(q: Tensor, k_new: Tensor, v_new: Tensor, cache_k: Tensor, cache_v: Tensor,
                 pos: Tensor, length: Tensor, *, mesh: Mesh, axis="model",
                 window: Optional[int] = None, softcap: float = 0.0) -> Tensor:
    """Write one token and attend, the cache sequence-sharded over ``axis``
    (reference :120): q (B, 1, H, Dh), k_new/v_new (B, 1, Kv, Dh), this
    rank's cache slice cache_k/cache_v (B, S_local, Kv, Dh) and pos
    (S_local,), the tokens seen ``length`` (a device scalar) → out (B, 1,
    H, Dh) in q's dtype. ``axis`` is one mesh axis, or several
    comma-joined or in a tuple (major to minor, as a ``PartitionSpec``
    tuple): shard i of the sequence is slots [i·S_local, (i+1)·S_local).

    Only the rank whose slice holds slot ``length mod S_cache`` writes
    k/v and records the position (in place, on the device: no host
    read); ``length`` is not advanced. Each rank takes an fp32 softmax
    over its visible slots (pos in [length − window, length], the
    soft-cap applied), and the ranks combine: an ``all_reduce(MAX)`` of
    the row maxima m, then one ``all_reduce(SUM)`` of s·e^(m − M) and
    o·e^(m − M) packed together: O(B·H·Dh) traffic, never the cache."""
    axes = lever_axes(axis)
    B, Scl, Kv, Dh = cache_k.shape
    n, my = axes_size(mesh, axes), mesh.index(axes)
    slot = torch.remainder(length, Scl * n)
    start = my * Scl
    owns = (slot >= start) & (slot < start + Scl)
    local = torch.clamp(slot - start, 0, Scl - 1).view(1).long()
    old_k, old_v = cache_k.index_select(1, local), cache_v.index_select(1, local)
    cache_k.index_copy_(1, local, torch.where(owns, k_new.to(cache_k.dtype), old_k))
    cache_v.index_copy_(1, local, torch.where(owns, v_new.to(cache_v.dtype), old_v))
    pos.index_copy_(0, local, torch.where(owns, length.to(pos.dtype), pos.index_select(0, local)))

    valid = (pos >= 0) & (pos <= length)
    if window is not None:
        valid = valid & (pos > length - window)
    group = q.shape[2] // Kv
    kk = torch.repeat_interleave(cache_k, group, dim=2).to(torch.float32)  # (B, Scl, H, Dh)
    vv = torch.repeat_interleave(cache_v, group, dim=2).to(torch.float32)
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kk) * (Dh ** -0.5)
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~valid[None, None, None, :], -1e30)
    m_loc = logits.amax(dim=-1)  # (B, H, 1)
    p = torch.exp(logits - m_loc[..., None]).masked_fill(~valid[None, None, None, :], 0.0)
    s_loc = p.sum(dim=-1)  # (B, H, 1)
    o_loc = torch.einsum("bhst,bthd->bshd", p, vv)  # (B, 1, H, Dh)

    if n > 1:
        grp = axes_group(mesh, axes)
        m_glob = m_loc.clone()  # m_loc stays this rank's
        _count(m_glob)
        dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=grp)
    else:
        m_glob = m_loc
    corr = torch.exp(m_loc - m_glob)  # (B, H, 1)
    packed = torch.cat([(s_loc * corr).reshape(B, -1),
                        (o_loc * corr.transpose(1, 2)[..., None]).reshape(B, -1)], dim=1)
    if n > 1:
        _count(packed)
        dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=grp)
    H = q.shape[2]
    s_glob = packed[:, :H].reshape(B, H, 1)
    o = packed[:, H:].reshape(B, 1, H, Dh)
    o = o / torch.clamp(s_glob, min=1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype)
