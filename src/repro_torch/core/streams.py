"""Per-slot noise streams as device data: the port of the reference's
(B, 2) per-slot keys (``SolverCarry.per_slot_keys``), drawn by P1, the
per-row Philox kernel (``kernels.philox``). A row's noise moves with its
row, and a captured CUDA graph draws for whichever request holds a slot.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.philox import ops as philox

Tensor = torch.Tensor


@dataclasses.dataclass
class SlotStreams:
    """Row i draws from the Philox stream (seed[i], counter[i]), so its
    noise depends on those two numbers alone, not on its slot or its
    seatmates.

    seed: (B,) int64, negative for an idle slot (whose draws are 0).
    counter: (B,) int64, the index of the row's next draw. A request's
    prior is its stream's draw at counter 0 and its noise draws follow
    from counter 1 (``sde.prior_sample``; the order ``sample(seed=...)``
    draws in). The draw reads the counter; the solver body returns the
    advanced counter as a new leaf. Compaction permutes both with
    ``index_select`` and admission writes them with ``index_copy_``, like
    every other per-slot leaf.
    """

    seed: Tensor
    counter: Tensor

    @classmethod
    def of(cls, seeds, counter=0, device="cuda") -> "SlotStreams":
        """Streams of integer ``seeds`` (B,), each at ``counter``, on
        ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
        seed = torch.as_tensor(seeds, dtype=torch.int64).reshape(-1).to(resolve_device(device))
        return cls(seed=seed, counter=torch.full_like(seed, int(counter)))

    @property
    def device(self) -> torch.device:
        return self.seed.device

    def draw(self, shape, offset: int = 0) -> Tensor:
        """(B, *shape) fp32 normals: each row's draw at counter + offset."""
        counter = self.counter if offset == 0 else self.counter + offset
        z = philox.normal(self.seed, counter, math.prod(shape))
        return z.reshape((self.seed.shape[0],) + tuple(shape))

    def advanced(self, by: Tensor) -> "SlotStreams":
        """The streams with every counter moved on by ``by`` (a 0-d or (B,)
        int tensor on the device)."""
        return SlotStreams(seed=self.seed, counter=self.counter + by)
