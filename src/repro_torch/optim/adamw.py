"""AdamW with decoupled weight decay and global-norm clipping; port of
``repro/optim/adamw.py``.

The arithmetic is the reference's, which is not ``torch.optim.AdamW``'s:
the weight decay enters the update before the learning-rate multiply,
the denominator is sqrt(v / bc2) + eps, b2 defaults to 0.95, and the
clip scale is min(1, clip / max(‖g‖, 1e-9)) (``clip_grad_norm_`` uses
clip / (‖g‖ + 1e-6)). The moments are fp32 whatever the parameters'
dtype, and the step counter is a Python int.

``update`` writes the new values into ``params`` in place (an
``nn.Module``'s parameters stay the same objects, so autograd and the
module keep seeing them) and returns ``(params, new_state)``, the
reference's pair.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.tree import leaves, tree_map

Tensor = torch.Tensor


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=0, mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def _lr(self, step: Tensor) -> Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32, device=step.device)

    def update(self, grads, state: AdamWState, params) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        with torch.no_grad():
            if self.clip_norm is not None:
                gnorm = global_norm(grads)
                scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
                grads = tree_map(lambda g: g * scale, grads)
            b1, b2 = self.b1, self.b2
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                          state.mu, grads)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
                          state.nu, grads)
            s = torch.full((), step, dtype=torch.float32, device=leaves(mu)[0].device)
            bc1 = 1 - b1 ** s
            bc2 = 1 - b2 ** s
            lr = self._lr(s)

            def upd(p, m, v):
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                u = u + self.weight_decay * p.to(torch.float32)
                p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))

            tree_map(upd, params, mu, nu)
        return params, AdamWState(step=step, mu=mu, nu=nu)


def global_norm(tree) -> Tensor:
    """sqrt of the sum over leaves of Σ x² (fp32), leaves added in order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)
