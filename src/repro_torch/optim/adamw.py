"""AdamW with decoupled weight decay and global-norm clipping; port of
``repro/optim/adamw.py``.

The arithmetic is the reference's, which is not ``torch.optim.AdamW``'s:
the weight decay enters the update before the learning-rate multiply,
the denominator is sqrt(v / bc2) + eps, b2 defaults to 0.95, and the
clip scale is min(1, clip / max(‖g‖, 1e-9)) (``clip_grad_norm_`` uses
clip / (‖g‖ + 1e-6)). The moments are fp32 whatever the parameters'
dtype, and the step counter is a Python int.

``update`` writes the new values into ``params`` and the moments into
the state's ``mu``/``nu`` in place (an ``nn.Module``'s parameters stay
the same objects, so autograd and the module keep seeing them; the state
passed in is spent) and returns ``(params, new_state)``, the reference's
pair. It goes leaf by leaf and through a large leaf ``CHUNK`` elements
at a time (elementwise arithmetic, so the same bits), so the update holds
two chunks' temporaries beside the parameters, gradients and moments: a
language model's optimizer step takes no second copy of any of them, and
a training step's peak memory is its activations', not the optimizer's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.tree import leaves, tree_map

Tensor = torch.Tensor

#: elements a pass of ``update`` and ``global_norm`` takes of a leaf
CHUNK = 1 << 24


def _chunks(t: Tensor):
    """``t``'s elements as views of at most CHUNK (t contiguous), else t."""
    return t.view(-1).split(CHUNK) if t.is_contiguous() else (t,)


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
            scale = None
            if self.clip_norm is not None:
                gnorm = global_norm(grads)
                scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            b1, b2 = self.b1, self.b2
            mu, nu = leaves(state.mu), leaves(state.nu)
            s = torch.full((), step, dtype=torch.float32, device=mu[0].device)
            bc1 = 1 - b1 ** s
            bc2 = 1 - b2 ** s
            lr = self._lr(s)
            for p, g, m, v in zip(leaves(params), leaves(grads), mu, nu, strict=True):
                if p.is_contiguous():  # m and v are: init made them
                    parts = zip(_chunks(p), g.reshape(-1).split(CHUNK), _chunks(m), _chunks(v))
                else:
                    parts = [(p, g, m, v)]
                for pc, gc, mc, vc in parts:
                    self._update_chunk(pc, gc, mc, vc, scale, bc1, bc2, lr)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

    def _update_chunk(self, p, g, m, v, scale, bc1, bc2, lr) -> None:
        """One chunk in place, with two temporaries; each product and sum
        rounded once as in the reference's expressions."""
        gs = g * scale if scale is not None else g.clone()
        gs = gs.to(torch.float32)
        t = gs * (1 - self.b1)
        m.mul_(self.b1).add_(t)
        torch.mul(gs, gs, out=t).mul_(1 - self.b2)
        v.mul_(self.b2).add_(t)
        torch.div(v, bc2, out=t).sqrt_().add_(self.eps)
        u = torch.div(m, bc1, out=gs).div_(t)
        pf = p if p.dtype == torch.float32 else p.to(torch.float32)
        u.add_(torch.mul(pf, self.weight_decay, out=t)).mul_(lr)
        if pf is p:
            p.sub_(u)
        else:
            p.copy_((pf - u).to(p.dtype))


def global_norm(tree) -> Tensor:
    """sqrt of the sum over leaves of Σ x² (fp32), leaves (and a large
    leaf's chunks) added in order."""
    total = 0
    for x in leaves(tree):
        for c in _chunks(x):
            total = total + torch.sum(torch.square(c.to(torch.float32)))
    return torch.sqrt(total)
