"""On-device solver step telemetry (DESIGN.md §15); port of
``repro/observability/telemetry.py``.

A fixed-size ring rides ``SolverCarry.telemetry``: every Algorithm-1
iteration in which some sample is active writes one column of each
slot's (t, h, err, accept) on the device, with no host sync; the host
decodes the buffers when it next pulls the carry.

  * **None is the off state.** ``SolverCarry.telemetry`` defaults to
    None and the loop body records only when it is set, so a carry
    without a ring runs exactly the untelemetered body.
  * **The head is monotone.** ``head`` counts every recorded iteration
    since the ring was made and is never reset (unlike the carry's
    ``iterations``, which the serve loop folds and resets at each sync);
    writes land at column ``head % capacity``, so the ring holds the
    last ``capacity`` iterations and ``head`` is the all-time count.
  * **Rows travel with their sample.** Compaction permutes the (B, cap)
    buffers along the batch axis like x; admission does not clear a row
    (records are stamped by the global iteration and age out by wrap).
    Idle-slot records carry t <= t_eps and are filtered on the host.
  * **Recording never feeds back.** The ring is written from values the
    body already computed; nothing reads it and no noise is drawn for it.

The reference's loop body runs only while a sample is active. The port's
``solve_chunk`` runs masked iterations between host syncs, so
``record_step`` takes a ``live`` flag (some sample active, a 0-d bool
tensor on the device): a masked iteration leaves the buffers and the head
as they were, and the ring is the reference's record for record.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class StepTelemetry:
    """Per-slot step-telemetry ring.

    t: (B, cap) fp32, each slot's time at iteration entry. h: (B, cap)
    fp32, the attempted step (0 for frozen slots, the body's active
    clamp). err: (B, cap) fp32, the scaled error norm. accept: (B, cap)
    bool. head: 0-d int32, the monotone write cursor.
    """

    t: Tensor
    h: Tensor
    err: Tensor
    accept: Tensor
    head: Tensor

    @property
    def batch(self) -> int:
        return self.t.shape[0]

    @property
    def capacity(self) -> int:
        return self.t.shape[1]


def init_telemetry(batch: int, capacity: int, device="cpu") -> StepTelemetry:
    """A fresh all-zero ring of ``batch`` slots × ``capacity`` records on
    ``device``."""
    cap = int(capacity)
    if cap <= 0:
        raise ValueError(f"telemetry capacity must be positive, got {cap}")
    shape = (int(batch), cap)
    zeros = lambda dtype: torch.zeros(shape, dtype=dtype, device=device)
    return StepTelemetry(t=zeros(torch.float32), h=zeros(torch.float32),
                         err=zeros(torch.float32), accept=zeros(torch.bool),
                         head=torch.zeros((), dtype=torch.int32, device=device))


def record_step(tel: StepTelemetry, *, t: Tensor, h: Tensor, err: Tensor,
                accept: Tensor, live: Tensor) -> StepTelemetry:
    """One iteration's column write at ``head % capacity``, on the device.

    ``live`` (0-d bool tensor, some sample active) gates the write: when
    false the buffers keep their column and the head does not move.
    """
    idx = torch.remainder(tel.head, tel.capacity).reshape(1).to(torch.long)

    def put(buf: Tensor, v: Tensor) -> Tensor:
        col = torch.where(live, v.to(buf.dtype).reshape(-1, 1), buf.index_select(1, idx))
        return buf.index_copy(1, idx, col)

    return StepTelemetry(t=put(tel.t, t), h=put(tel.h, h), err=put(tel.err, err),
                         accept=put(tel.accept, accept),
                         head=tel.head + live.to(torch.int32))


def telemetry_history(tel: StepTelemetry) -> dict:
    """Host-side chronological decode of a ring (tensors on any device,
    or numpy arrays).

    Returns ``{"t", "h", "err", "accept"}`` as (B, n) numpy arrays in
    iteration order, the last ``n = min(head, capacity)`` records oldest
    first, plus ``"iterations"`` (the all-time head) and ``"records"``
    (n).
    """
    host = lambda a: a.cpu().numpy() if isinstance(a, Tensor) else np.asarray(a)
    head = int(host(tel.head))
    cap = int(host(tel.t).shape[1])
    n = min(head, cap)
    cols = np.arange(head - n, head) % cap if n else np.zeros(0, np.int64)
    out = {name: host(getattr(tel, name))[:, cols]
           for name in ("t", "h", "err", "accept")}
    out["iterations"] = head
    out["records"] = n
    return out
