"""GPipe pipeline parallelism over a mesh axis; port of
``repro/parallel/pipeline.py`` (``_pipeline_local`` :33-79,
``pipeline_forward`` :82-123).

The layer stack is cut over the pipeline axis: of R layers, the rank at
stage s of n holds the contiguous R/n layers ``stage_layers`` names. The
batch flows through the stages in M microbatches: at tick t, stage s runs
its layers on microbatch t − s when 0 ≤ t − s < M, over M + n − 1 ticks,
and hands the result to stage s + 1 (``collectives.stage_handoff``,
point-to-point; every stage first joins one call on the axis's group,
``collectives.open_stage_group``, as NCCL asks of a group's first
call). The bubble fraction is (n − 1)/(M + n − 1). A tick with
nothing to do runs nothing; the reference runs its body on zeros there,
with the same outputs.

The last stage's (M, mb, ...) outputs reach every stage of the axis by a
broadcast from the last stage (``collectives.stage_broadcast``), where
the reference sums zeros from the other stages (:77-79): the same bits,
fewer bytes. At one stage no collective runs, and the result is bitwise
the stage run microbatch by microbatch.

Forward only, as the reference: the motivating workload is the
diffusion sampler's score-network forward
(``launch/sample.py::make_pipelined_dit_forward``).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def stage_layers(num_layers: int, mesh: Mesh, axis: str = "pod") -> range:
    """The layers of this rank's stage: the contiguous R/n of R layers at
    its coordinate on ``axis``. Raises ``ValueError`` when n does not
    divide R."""
    n, s = mesh.shape[axis], mesh.coord(axis)
    if num_layers % n:
        raise ValueError(f"{num_layers} layers do not split into {n} stages over {axis!r}")
    per = num_layers // n
    return range(s * per, (s + 1) * per)


def pipeline_forward(stage: Callable[[Tensor], Tensor], x: Tensor, *, mesh: Mesh,
                     axis: str = "pod", num_microbatches: int = 4) -> Tensor:
    """Run the layer stack over x (B, ...), pipelined over ``axis``.

    ``stage(x_mb)`` runs this rank's layers (``stage_layers``) on one
    microbatch (B/M, ...) and returns a tensor of the same shape (the
    reference's x-shaped carry). ``x`` is the whole batch on every rank
    (the reference's ``in_specs=P()``); only the first stage reads it.
    Returns the (B, ...) output on every rank (``out_specs=P()``). Raises
    ``ValueError`` when M does not divide B."""
    B, M = x.shape[0], num_microbatches
    if M < 1 or B % M:
        raise ValueError(f"a batch of {B} does not split into {M} microbatches")
    n, s = mesh.shape[axis], mesh.coord(axis)
    xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
    coll.open_stage_group(mesh, axis, x)
    outs = [None] * M
    inbuf = None
    for t in range(M + n - 1):
        i = t - s
        y = None
        if 0 <= i < M:
            y = stage(xs[i] if s == 0 else inbuf)
            if s == n - 1:
                outs[i] = y
        send = y if s < n - 1 else None
        recv = xs[0] if s > 0 and 0 <= t + 1 - s < M else None
        if send is not None or recv is not None:
            inbuf = coll.stage_handoff(send, recv, mesh, axis)
    out = torch.stack(outs) if s == n - 1 else torch.empty_like(xs)
    out = coll.stage_broadcast(out, mesh, axis, owner=n - 1)
    return out.reshape((B,) + tuple(out.shape[2:]))
