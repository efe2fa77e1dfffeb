"""Collectives; port of ``repro/parallel/collectives.py``
(``scaled_error_l2_psum``, ``flash_decode``), plus what the reference
leaves to XLA: for sampling and serving, the O(1) loop-control reduction
(``all_max``, also the device-resident driver's event flags), the row
gather, and the serve loop's two gathers at a sync: the (B_local,)
bookkeeping vectors into (B,) (``gather_slot_vectors``) and the retired
rows to every rank (``gather_retired``); for the language models under
a mesh, the collectives GSPMD inserts for the reference's forward and
train steps: the sum of partial products over an axis
(``all_reduce_sum``), the gather of a dimension (``all_gather_dim``),
the reduce-scatter of a dimension (``reduce_scatter_dim``), and their
backward passes; and on the head's output, left cut over the vocabulary
as GSPMD leaves it, the loss (``vocab_parallel_cross_entropy``) and the
greedy pick (``vocab_parallel_argmax``).

Every collective runs over a group of the port's ``Mesh``
(``torch.distributed``: NCCL on the card, gloo on the CPU, or gloo on the
card with two ranks on one card). Under autograd the LM's model-axis
collectives are ``torch.autograd.Function``s with the Megatron
convention's backward passes (the notes above ``_AllReduceSum``):
``all_reduce_sum`` (identity backward), ``enter_model_region`` (identity
forward, all-reduce backward; new calls, one at each entry into
computation on a rank's slice, named where the layers make them),
``all_gather_dim`` (each call says which backward: "own" or
"reduce_scatter"), ``split_dim`` and ``reduce_scatter_dim`` (all-gather
backward). Without autograd they run as before: forward only, in place
where they can. Training adds the data-axis collectives GSPMD inserts
for the reference's train step: the gradients' sum over the data axes
(``reduce_gradients``), ZeRO-3's gather of a data-sharded leaf with a
reduce-scatter backward (``fsdp_gather``; ``fsdp_broadcast`` where the
leaf is cut on its repeat axis) and ZeRO-1's gather of the updated
blocks (``zero1_gather_``). A pipeline over a mesh axis
(``parallel/pipeline.py``) hands activations to the next stage with
point-to-point calls (``stage_handoff``) and sends the last stage's
outputs to every stage (``stage_broadcast``).

``calls`` and ``nbytes`` count every collective these functions run
(the retired rows' gather and the K4 error combine aside) and the bytes each
rank sends into it, ``by_kind`` the same by the port's kinds (forward,
remat's recompute, backward, the data-axis kinds, the loop control, the
pipeline's), and ``ops`` by the reference's five op kinds
(``repro/analysis/hlo.py:23-24``) with the bytes of each call's result
on this rank, as the reference counts an HLO result shape
(``hlo.py:36-64``). A call made while its stream is captured into a
CUDA graph is booked in ``captured`` instead, since it runs only when
the graph is replayed: the code that replays a graph charges the books
its capture made (``captured_since``, ``charge``) once a replay, as the
kernel wrappers' launch counts are charged. ``counting()`` is the dry runs' mode: inside it a
collective on meta tensors over a ``Mesh`` without process groups books
its call as a real one would and returns a meta tensor of its result's
shape, so one rank of a 256- or 512-device mesh can be counted on one
host.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import weakref
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.sharding import data_axes, lever_axes, split_rows

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
    """Element-wise maximum of ``t`` over ``group`` (a process group, or a
    ``Mesh``: its whole group), in place; booked as "loop_control"."""
    _count(t, "loop_control")
    if isinstance(group, Mesh):
        if _counted(t, group):
            return t
        group = group.group()
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
    each rank's index over the data axes. Booked as "result_gather", and
    as the reference's "all-gather" of the whole (B, ...) result.
    """
    if sharding.replicated:
        return t
    label = _count(t, "result_gather", "all-gather", sharding.n_shards * t.numel())
    if _counted(t, mesh):
        return _made(t, (sharding.n_shards * t.shape[0], *t.shape[1:]), label)
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
#: they were last set to 0 (``reset``), in all and by kind: forward (the
#: sums and gathers of a forward pass, and ``flash_decode``); recompute
#: (the same, run again by ``remat`` inside the backward pass); backward
#: (the backward passes' collectives); grad_reduce (the gradients' sum
#: over the data axes); fsdp_gather and fsdp_scatter (a ZeRO-3 leaf's
#: gather or broadcast, and its gradient's reduce-scatter or reduce);
#: zero1_gather (the updated blocks' gather); clip_norm and metrics (the
#: step's small sums); checkpoint (a leaf gathered whole for saving);
#: loop_control (the solver's sync, ``all_max``); stage_handoff and
#: stage_broadcast (a pipeline's); result_gather (a step's rows gathered
#: to every rank, ``gather_rows``)
calls = 0
nbytes = 0
by_kind: dict = {}
#: the same calls by the reference's op kinds, with the bytes of each
#: call's result on this rank (a gather's whole, a reduce-scatter's block)
ops: dict = {}
REFERENCE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute")

_counting = False
#: the open ``counting``'s list of the results its gathers made
_results: list = []


def reset() -> None:
    """Set every count to 0."""
    global calls, nbytes
    calls = nbytes = 0
    by_kind.clear()
    ops.clear()


def counts() -> dict:
    """{kind: (calls, bytes)} since the last ``reset``."""
    return {k: tuple(v) for k, v in by_kind.items()}


def op_counts() -> dict:
    """{reference op kind: (calls, result bytes)} since the last ``reset``."""
    return {k: tuple(v) for k, v in ops.items()}


def books() -> dict:
    """The collectives since the last ``reset`` as a dry run records them:
    calls and result bytes by the reference's op kinds (its record's
    fields), and calls and sent bytes by the port's kinds."""
    return {"bytes_by_kind": {k: v[1] for k, v in ops.items()},
            "counts": {k: v[0] for k, v in ops.items()},
            "total_bytes": sum(v[1] for v in ops.values()),
            "port_kinds": {k: {"calls": v[0], "bytes": v[1]} for k, v in by_kind.items()}}


@contextlib.contextmanager
def counting():
    """The dry runs' mode. Inside it every collective on a meta tensor over
    a ``Mesh`` without a ``DeviceMesh`` (``launch/mesh.py::
    make_production_mesh``) books its call as a real one would and returns
    a meta tensor of its result's shape: a gather multiplies the gathered
    dimension by the ranks, a reduce-scatter divides it, a sum or a
    broadcast keeps it. Outside it nothing changes, and a one-rank axis
    is no call at all either way. It yields a list to which every counted
    gather adds the result it made, as (bytes, "op (kind)", shape)."""
    global _counting, _results
    before = _counting, _results
    _counting, _results = True, []
    try:
        yield _results
    finally:
        _counting, _results = before


def _counted(t: Tensor, mesh: Mesh) -> bool:
    """True where the call is only counted (``counting``)."""
    return _counting and t.is_meta and mesh.device_mesh is None


def _made(t: Tensor, shape, label: str) -> Tensor:
    """A counted gather's result: a meta tensor of ``shape``, listed in
    ``counting``'s list under ``label`` (``_count``'s)."""
    out = t.new_empty(shape)
    _results.append((out.numel() * out.element_size(), label, tuple(out.shape)))
    return out


def _count(t: Tensor, kind: Optional[str] = None, op: str = "all-reduce",
           out_numel: Optional[int] = None) -> str:
    """Book one call on ``t`` (the tensor this rank puts in) as ``kind``,
    and as the reference's ``op`` with a result of ``out_numel`` elements
    (``t``'s by default); returns "op (kind)". A call made while ``t``'s
    stream is captured into a CUDA graph runs nothing yet: it is booked in
    ``captured`` instead, and whoever replays the graph charges it
    (``charge``)."""
    global calls, nbytes
    if kind is None:  # a forward collective; inside a backward pass, remat's recompute
        kind = "recompute" if torch._C._current_graph_task_id() != -1 else "forward"
    size = t.numel() * t.element_size()
    out = (t.numel() if out_numel is None else out_numel) * t.element_size()
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        _book(captured["by_kind"], kind, 1, size)
        _book(captured["ops"], op, 1, out)
        return f"{op} ({kind})"
    calls += 1
    nbytes += size
    _book(by_kind, kind, 1, size)
    _book(ops, op, 1, out)
    return f"{op} ({kind})"


def _book(table: dict, name: str, n: int, size: int) -> None:
    c = table.setdefault(name, [0, 0])
    c[0] += n
    c[1] += size


#: the calls booked while a CUDA graph was captured, by the port's kinds
#: and by the reference's op kinds, as ``by_kind`` and ``ops`` book them;
#: never set to 0: the difference across a capture (``captured_since``)
#: is what one replay of that graph runs
captured: dict = {"by_kind": {}, "ops": {}}


def captured_books() -> dict:
    """A copy of ``captured``, to take a capture's books from
    (``captured_since``)."""
    return {k: {n: list(v) for n, v in t.items()} for k, t in captured.items()}


def captured_since(before: dict) -> dict:
    """The calls booked in ``captured`` since ``before``
    (``captured_books``): one replay's books of the graph captured in
    between."""
    return {k: {n: [c - before[k].get(n, (0, 0))[0], b - before[k].get(n, (0, 0))[1]]
                for n, (c, b) in t.items() if c != before[k].get(n, (0, 0))[0]}
            for k, t in captured.items()}


def charge(books: dict, times: int = 1) -> None:
    """Book ``times`` replays of a graph whose capture booked ``books``
    (``captured_since``): the collectives a replay runs, which Python
    does not call."""
    global calls, nbytes
    times = int(times)
    for name, (c, b) in books["by_kind"].items():
        calls += c * times
        nbytes += b * times
        _book(by_kind, name, c * times, b * times)
    for name, (c, b) in books["ops"].items():
        _book(ops, name, c * times, b * times)


#: the process groups spanning several (not all) axes of a mesh, by mesh
#: and axes (``axes_group``)
_spans = weakref.WeakKeyDictionary()


def axes_group(mesh: Mesh, axes: Sequence[str]):
    """The process group spanning ``axes`` of ``mesh``: one axis's group,
    the whole mesh's when ``axes`` are all of its axes, else (the data
    axes ("pod", "data") of a mesh with "model") the group of this rank's
    positions over ``axes``, made on first use: every rank makes every
    such group at once (``new_subgroups_by_enumeration``), which the
    ranks' same program order gives. ``axes`` run major to minor in the
    mesh's order, as the group's ranks do."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.group(axes[0])
    if set(axes) == set(mesh.axis_names):
        return mesh.group()
    dims = [mesh.axis_names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} out of the mesh's order {mesh.axis_names}")
    made = _spans.setdefault(mesh, {})
    if axes not in made:
        other = [d for d in range(len(mesh.sizes)) if d not in dims]
        grid = np.transpose(np.asarray(mesh.ranks()), other + dims)
        spans = grid.reshape(-1, math.prod(mesh.sizes[d] for d in dims)).tolist()
        made[axes] = dist.new_subgroups_by_enumeration(spans)[0]
    return made[axes]


def axes_size(mesh: Mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _owned(t: Tensor) -> Tensor:
    """A contiguous tensor the caller may overwrite: a gradient handed to a
    backward pass can be shared with another input's (an add's)."""
    return t.clone(memory_format=torch.contiguous_format)


def _sum_(t: Tensor, mesh: Mesh, axes, kind: Optional[str]) -> Tensor:
    """All-reduce (sum) of the contiguous ``t`` over ``axes``, in place."""
    _count(t, kind)
    if _counted(t, mesh):
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axes_group(mesh, axes))
    return t


def _gather(t: Tensor, dim: int, mesh: Mesh, axes, kind: Optional[str]) -> Tensor:
    """Every rank's ``t`` over ``axes`` concatenated along ``dim``; group
    rank i sits at mesh index i over these axes (row-major mesh)."""
    t = t.contiguous()
    n = axes_size(mesh, axes)
    label = _count(t, kind, "all-gather", n * t.numel())
    if _counted(t, mesh):
        shape = list(t.shape)
        shape[dim] *= n
        return _made(t, shape, label)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=axes_group(mesh, axes))
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t: Tensor, dim: int, mesh: Mesh, axes, kind: Optional[str]) -> Tensor:
    """This rank's block (of n along ``dim``) of the sum over ``axes``.
    NCCL reduce-scatters; gloo, which cannot, all-reduces and keeps the
    rank's block (the same numbers)."""
    n = axes_size(mesh, axes)
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over {n} ranks of {axes}")
    i, b = mesh.index(axes), size // n
    _count(t, kind, "reduce-scatter", t.numel() // n)
    if _counted(t, mesh):
        return t.narrow(dim, i * b, b).contiguous()
    group = axes_group(mesh, axes)
    if dist.get_backend(group) == "nccl":
        parts = [p.contiguous() for p in t.split(b, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
        return out
    buf = _owned(t)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.narrow(dim, i * b, b)


def _block(t: Tensor, dim: int, mesh: Mesh, axes) -> Tensor:
    """This rank's block of n equal blocks of ``t`` along ``dim``."""
    b = t.shape[dim] // axes_size(mesh, axes)
    return t.narrow(dim, mesh.index(axes) * b, b)


def _grad_on(t: Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


# The autograd pair (the Megatron convention). A tensor is *replicated*
# when every rank of "model" holds the same values, and then its gradient
# is the whole gradient, the same on every rank; it is *partial* when the
# ranks hold different summands or slices, and then each holds its part
# of the gradient. ``all_reduce_sum`` turns partial sums into a
# replicated tensor: every rank's upstream gradient is the same, so its
# backward is the identity. ``enter_model_region`` marks where a
# replicated tensor is consumed by computation on the rank's slice only
# (a sharded projection's input, a replicated leaf of which a rank uses a
# part): the identity forward, and a backward that sums the ranks' partial
# gradients. ``all_gather_dim`` says at each call which backward follows
# from what comes after the gather: "own" (every rank computes the same
# thing after it: the rank takes its block of the whole gradient) or
# "reduce_scatter" (ranks compute different things after it: the sum of
# their gradients, the rank's block). ``split_dim`` (the rank's block of a
# replicated tensor) is ``all_gather_dim``'s "own" mirror, and
# ``reduce_scatter_dim``'s backward is an all-gather.


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _sum_(_owned(t), mesh, axes, None)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum_(_owned(g), ctx.mesh, ctx.axes, "backward"), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axes, backward):
        ctx.dim, ctx.mesh, ctx.axes, ctx.backward = dim, mesh, axes, backward
        return _gather(t, dim, mesh, axes, None)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "own":
            g = _block(g, ctx.dim, ctx.mesh, ctx.axes)
        else:
            g = _reduce_scatter(g, ctx.dim, ctx.mesh, ctx.axes, "backward")
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _reduce_scatter(t, dim, mesh, axes, None)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.mesh, ctx.axes, "backward"), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axis):
        n, r = mesh.shape[axis], mesh.coord(axis)
        size = t.shape[dim]
        a, b = split_rows(size, n, r)
        ctx.dim, ctx.mesh, ctx.axis, ctx.size, ctx.block = dim, mesh, axis, size, -(-size // n)
        return t.narrow(dim, a, b - a)

    @staticmethod
    def backward(ctx, g):
        pad = ctx.block - g.shape[ctx.dim]
        if pad:
            shape = list(g.shape)
            shape[ctx.dim] = pad
            g = torch.cat([g, g.new_zeros(shape)], dim=ctx.dim)
        full = _gather(g, ctx.dim, ctx.mesh, (ctx.axis,), "backward")
        return full.narrow(ctx.dim, 0, ctx.size), None, None, None


def all_reduce_sum(t: Tensor, mesh: Mesh, axis: str = "model") -> Tensor:
    """The sum of every rank's ``t`` over ``axis`` (every rank gets the same
    bits; partial sums → a replicated tensor, the identity backward). A
    one-rank axis returns ``t``. Without autograd it reduces ``t`` in place
    where ``t`` is contiguous (the caller never reads its input again)."""
    if mesh.shape[axis] == 1:
        return t
    if _grad_on(t):
        return _AllReduceSum.apply(t, mesh, (axis,))
    return _sum_(t.contiguous(), mesh, (axis,), None)


def enter_model_region(t: Tensor, mesh: Mesh, axis: str = "model") -> Tensor:
    """``t`` (replicated over ``axis``) where it enters computation on the
    rank's slice: the identity, and in the backward pass the sum of the
    ranks' partial gradients. A one-rank axis, or ``t`` outside autograd,
    returns ``t``."""
    if mesh.shape[axis] == 1 or not _grad_on(t):
        return t
    return _EnterRegion.apply(t, mesh, (axis,))


def all_gather_dim(t: Tensor, dim: int, mesh: Mesh, axes: Union[str, Sequence[str]] = "model",
                   *, backward: str) -> Tensor:
    """Every rank's ``t`` over ``axes``, concatenated along ``dim`` in the
    ranks' order over ``axes`` (major to minor). ``backward`` names what
    follows the gather (module notes above): "own" or "reduce_scatter".
    A one-rank span returns ``t``."""
    if backward not in ("own", "reduce_scatter"):
        raise ValueError(f"backward must be 'own' or 'reduce_scatter', got {backward!r}")
    axes = _axes(axes)
    if axes_size(mesh, axes) == 1:
        return t
    if _grad_on(t):
        return _AllGather.apply(t, dim, mesh, axes, backward)
    return _gather(t, dim, mesh, axes, None)


def _max_(t: Tensor, mesh: Mesh, axes) -> Tensor:
    """All-reduce (maximum) of the contiguous ``t`` over ``axes``, in place;
    booked as a forward "all-reduce"."""
    _count(t)
    if _counted(t, mesh):
        return t
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axes_group(mesh, axes))
    return t


# The LM head's output stays cut over the vocabulary (the reference's
# GSPMD keeps it so): a rank holds the logits of its V/n columns, the
# loss and the greedy pick combine the ranks' partial results over
# "model", and no rank builds the (rows, S, V) logits.


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, first, mesh, axis):
        Vl = logits.shape[-1]
        m = _max_(logits.amax(dim=-1).contiguous(), mesh, (axis,))
        e = torch.exp(logits - m[..., None])
        local = targets.long() - first
        inside = (local >= 0) & (local < Vl)
        idx = local.clamp(0, Vl - 1)
        own = torch.gather(logits, -1, idx[..., None])[..., 0].masked_fill(~inside, 0.0)
        # Σexp and the target's logit (one rank holds it; the others add 0)
        sums = _sum_(torch.stack([e.sum(dim=-1), own]), mesh, (axis,), None)
        nll = torch.log(sums[0]) + m - sums[1]
        ctx.save_for_backward(e.div_(sums[0][..., None]), idx, inside)
        ctx.n = nll.numel()
        return torch.mean(nll)

    @staticmethod
    def backward(ctx, g):
        p, idx, inside = ctx.saved_tensors
        grad = p.scatter_add(-1, idx[..., None], -inside.to(p.dtype)[..., None])
        return grad.mul_(g / ctx.n), None, None, None, None


def vocab_parallel_cross_entropy(logits: Tensor, targets: Tensor, first: int, mesh: Mesh,
                                 axis: str = "model") -> Tensor:
    """The mean cross-entropy of ``targets`` (..., an integer id a
    position) under logits cut over the vocabulary across ``axis``
    (Megatron's ``vocab_parallel_cross_entropy``): ``logits`` (..., V/n)
    are this rank's columns, ids [first, first + V/n), cast to fp32 here.
    The mean is over every position, as ``data.tokens.lm_loss`` takes it
    (reference ``repro/data/tokens.py:92-98``): the caller passes the
    predicting positions and the next tokens.

    Forward: one all-reduce MAX of the row maxima, then one all-reduce SUM
    of Σexp(l − max) and the target's logit packed together, so nll = log
    Σ + max − l_target; every rank of ``axis`` gets the same bits, and the
    sums run in the backend's fixed order (no atomics), so a second call
    gives them again. Backward: (softmax − onehot)·g / N on the rank's
    columns, with no collective (the head's input gradient is summed by
    the ``enter_model_region`` before the head)."""
    return _VocabParallelCE.apply(logits.to(torch.float32), targets, first, mesh, axis)


def vocab_parallel_argmax(logits: Tensor, first: int, mesh: Mesh,
                          axis: str = "model") -> Tensor:
    """The greedy pick over logits cut over the vocabulary across
    ``axis``: ``logits`` (..., V/n) are this rank's columns, ids [first,
    first + V/n). Returns the global ids (...) int64, bitwise
    ``torch.argmax`` of the gathered logits: each rank takes its first
    local maximum and its id, one all-gather over ``axis`` collects the
    (value, id) pairs, and the largest value wins, among equal values the
    lowest id (the lowest rank's: the ranks' ids rise with the rank),
    which is ``torch.argmax``'s rule. The pairs travel in fp32 (fp64 for
    fp64 logits), which holds every bf16/fp32 value and every id below
    2^24 exactly."""
    dtype = torch.promote_types(logits.dtype, torch.float32)
    if logits.shape[-1] * mesh.shape[axis] > 2 ** 24:
        dtype = torch.float64
    loc = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, loc[..., None])[..., 0]
    pairs = torch.stack([val.to(dtype), (loc + first).to(dtype)], dim=-1)
    every = _gather(pairs[None], 0, mesh, (axis,), None)  # (n, ..., 2)
    win = torch.argmax(every[..., 0], dim=0)
    return torch.gather(every[..., 1], 0, win[None])[0].long()


def gather_whole(t: Tensor, sharding) -> Tensor:
    """The whole leaf from every rank's block ``t`` (its ``ParamSharding``):
    one all-gather a cut dimension, over its axes (a checkpoint's
    gather, outside autograd)."""
    with torch.no_grad():
        for d, e in enumerate(sharding.spec):
            axes = lever_axes(e)
            if axes and axes_size(sharding.mesh, axes) > 1:
                t = _gather(t, d, sharding.mesh, axes, "checkpoint")
    return t


def reduce_scatter_dim(t: Tensor, dim: int, mesh: Mesh, axis: str = "model") -> Tensor:
    """This rank's block (of ``n`` equal blocks along ``dim``) of the sum of
    every rank's ``t`` over ``axis``; its backward all-gathers."""
    if mesh.shape[axis] == 1:
        return t
    if _grad_on(t):
        return _ReduceScatter.apply(t, dim, mesh, (axis,))
    return _reduce_scatter(t, dim, mesh, (axis,), None)


def split_dim(t: Tensor, dim: int, mesh: Mesh, axis: str = "model") -> Tensor:
    """The rank's rows of a replicated ``t`` along ``dim``: block i of
    ⌈size/n⌉ (the last ones short or empty, ``sharding.split_rows``); its
    backward all-gathers the ranks' gradients. A one-rank axis returns
    ``t``."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    if _grad_on(t):
        return _Split.apply(t, dim, mesh, axis)
    a, b = split_rows(t.shape[dim], n, mesh.coord(axis))
    return t.narrow(dim, a, b - a)


# --------------------------------------------------------------------------
# the data axes: training's gradient sum, ZeRO-3 and ZeRO-1
# --------------------------------------------------------------------------

def reduce_gradients(grads: Sequence[Tensor], mesh: Mesh, skip: Sequence[bool] = ()) -> list:
    """Every gradient summed over the data axes of ``mesh``, one all-reduce
    a leaf (``torch.autograd.grad`` returns them all at once), in place
    where a gradient is contiguous. ``skip[i]`` leaves gradient i alone (a
    data-sharded leaf's gradient is already its block of the sum)."""
    grads = list(grads)
    axes = data_axes(mesh)
    if axes_size(mesh, axes) == 1:
        return grads
    for i, g in enumerate(grads):
        if not (skip and skip[i]):
            grads[i] = _sum_(g.contiguous(), mesh, axes, "grad_reduce")
    return grads


def sum_over(t: Tensor, mesh: Mesh, axes, kind: str) -> Tensor:
    """The sum of ``t`` over ``axes`` (a copy; ``t`` itself on one rank)."""
    axes = _axes(axes)
    if not axes or axes_size(mesh, axes) == 1:
        return t
    return _sum_(_owned(t), mesh, axes, kind)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _gather(t, dim, mesh, axes, "fsdp_gather")

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.mesh, ctx.axes, "fsdp_scatter"), None, None, None


def _broadcast(t: Tensor, mesh: Mesh, axes, owner: int, mine: bool,
               kind: str = "fsdp_gather", op: str = "all-gather") -> Tuple[Tensor, int]:
    """The owner's ``t`` on every rank of ``axes`` (a copy), and the
    owner's global rank (None when only counted). ``op`` is the
    reference's op this broadcast stands for: ZeRO-3's gather of a layer
    by default."""
    buf = _owned(t) if mine else torch.empty(t.shape, dtype=t.dtype, device=t.device)
    _count(buf, kind, op)
    if _counted(buf, mesh):
        return buf, None
    group = axes_group(mesh, axes)
    src = dist.get_global_rank(group, owner)
    dist.broadcast(buf, src=src, group=group)
    return buf, src


class _FsdpBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, owner, mine):
        buf, ctx.src = _broadcast(t, mesh, axes, owner, mine)
        ctx.mesh, ctx.axes, ctx.mine = mesh, axes, mine
        return buf

    @staticmethod
    def backward(ctx, g):
        g = _owned(g)
        _count(g, "fsdp_scatter")
        if _counted(g, ctx.mesh):
            return (g if ctx.mine else None), None, None, None, None
        group = axes_group(ctx.mesh, ctx.axes)
        if dist.get_backend(group) == "nccl":
            dist.reduce(g, dst=ctx.src, op=dist.ReduceOp.SUM, group=group)
        else:  # gloo reduces CPU tensors only: all-reduce, the owner keeps it
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return (g if ctx.mine else None), None, None, None, None


def fsdp_gather(t: Tensor, dim: int, mesh: Mesh, axes) -> Tensor:
    """A ZeRO-3 leaf's whole value over the data ``axes`` from this rank's
    block ``t`` (cut along ``dim``): an all-gather, whose backward
    reduce-scatters the gradient back to the rank's block."""
    axes = _axes(axes)
    if axes_size(mesh, axes) == 1:
        return t
    if _grad_on(t):
        return _FsdpGather.apply(t, dim, mesh, axes)
    return _gather(t, dim, mesh, axes, "fsdp_gather")


def fsdp_broadcast(t: Tensor, mesh: Mesh, axes, owner: int, mine: bool) -> Tensor:
    """One layer of a stacked leaf sharded over the data ``axes`` on its
    repeat axis: the layer lives whole on the rank at data index
    ``owner``, which broadcasts it (``t``: the layer where ``mine``, else
    any tensor of its shape, whose values are not read). The backward
    reduces the gradient to the owner (gloo: all-reduces), the only rank
    that keeps it (the others return none). Every rank calls it, for
    every layer."""
    axes = _axes(axes)
    if _grad_on(t):
        return _FsdpBroadcast.apply(t, mesh, axes, owner, mine)
    return _broadcast(t, mesh, axes, owner, mine)[0]


def zero1_gather_(p: Tensor, block: Tensor, dim: int, mesh: Mesh) -> None:
    """ZeRO-1: write every data rank's updated ``block`` of ``p`` (blocks
    along ``dim``) into ``p``, one all-gather over the data axes."""
    p.copy_(_gather(block, dim, mesh, data_axes(mesh), "zero1_gather"))


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

    counted = n > 1 and _counted(q, mesh)
    if n > 1:
        m_glob = m_loc.clone()  # m_loc stays this rank's
        _count(m_glob)
        if not counted:
            grp = axes_group(mesh, axes)
            dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=grp)
    else:
        m_glob = m_loc
    corr = torch.exp(m_loc - m_glob)  # (B, H, 1)
    packed = torch.cat([(s_loc * corr).reshape(B, -1),
                        (o_loc * corr.transpose(1, 2)[..., None]).reshape(B, -1)], dim=1)
    if n > 1:
        _count(packed)
        if not counted:
            dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=grp)
    H = q.shape[2]
    s_glob = packed[:, :H].reshape(B, H, 1)
    o = packed[:, H:].reshape(B, 1, H, Dh)
    o = o / torch.clamp(s_glob, min=1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype)


# --------------------------------------------------------------------------
# the pipeline's stage boundaries (parallel/pipeline.py)
# --------------------------------------------------------------------------

#: the (mesh, axis) pairs whose group has run a collective that every
#: stage joined (``open_stage_group``)
_opened = weakref.WeakKeyDictionary()


def open_stage_group(mesh: Mesh, axis: str, like: Tensor) -> None:
    """Let the stage handoffs over ``axis`` start: the first call on an
    NCCL group must include every rank of it, and a pipeline's first
    ticks hand off between two stages only. So every stage joins one
    all-reduce of a single value on the group, once per ``mesh`` and
    axis, before its first handoff (``like``: a tensor on the rank's
    device). It moves no data of the model and is not booked. Nothing
    runs at one stage or inside ``counting``."""
    if mesh.shape[axis] == 1 or _counted(like, mesh):
        return
    done = _opened.setdefault(mesh, set())
    if axis in done:
        return
    group = mesh.group(axis)
    dev = "cpu" if dist.get_backend(group) == "gloo" else like.device
    dist.all_reduce(torch.zeros(1, device=dev), group=group)
    done.add(axis)


def stage_handoff(send: Optional[Tensor], recv_like: Optional[Tensor], mesh: Mesh,
                  axis: str) -> Optional[Tensor]:
    """One tick's boundary of a pipeline over ``axis`` (the reference's
    ``ppermute`` to stage + 1): ``send`` goes to the next stage, and a
    tensor shaped like ``recv_like`` comes from the previous one; the two
    are posted together (``batch_isend_irecv``), so neither waits for the
    other. Either may be None (the first stage receives nothing, the last
    sends nothing, an idle tick neither). Returns what was received, or
    None. A handoff is booked once, by its sender: "stage_handoff", the
    reference's "collective-permute". Over gloo the tensors pass through
    the host."""
    if send is not None:
        send = send.contiguous()
        _count(send, "stage_handoff", "collective-permute")
    first = send if send is not None else recv_like
    if first is None:
        return None
    if _counted(first, mesh):
        return None if recv_like is None else torch.empty_like(recv_like)
    group, s = mesh.group(axis), mesh.coord(axis)
    dev = first.device
    host = dist.get_backend(group) == "gloo" and dev.type != "cpu"
    p2p, got = [], None
    if send is not None:
        p2p.append(dist.P2POp(dist.isend, send.cpu() if host else send,
                              dist.get_global_rank(group, s + 1), group))
    if recv_like is not None:
        got = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                          device="cpu" if host else recv_like.device)
        p2p.append(dist.P2POp(dist.irecv, got, dist.get_global_rank(group, s - 1), group))
    for work in dist.batch_isend_irecv(p2p):
        work.wait()
    return None if got is None else got.to(dev)


def stage_broadcast(t: Tensor, mesh: Mesh, axis: str, owner: int) -> Tensor:
    """The stage at ``owner`` of ``axis`` sends ``t`` to every stage (a
    copy on each; ``t``'s values are read on the owner only). The
    reference sums the last stage's outputs with the other stages' zeros
    (a psum, ``repro/parallel/pipeline.py:77-79``); the broadcast gives
    the owner's bits exactly and moves fewer bytes. Booked as
    "stage_broadcast", and as the reference's "all-reduce", the op it
    stands for."""
    if mesh.shape[axis] == 1:
        return t
    return _broadcast(t, mesh, (axis,), owner, mesh.coord(axis) == owner,
                      kind="stage_broadcast", op="all-reduce")[0]
