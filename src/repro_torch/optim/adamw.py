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

Under a mesh (``shardings=``: the ``ParamSharding`` tree of the rank's
parameter and gradient blocks) the clip norm is global: each rank sums
the squares of its blocks, a leaf held alike by k ranks weighted 1/k,
and one all-reduce over the whole mesh finishes the sum, so every rank
takes the same clip scale. The update itself runs on the rank's blocks
unchanged. ZeRO-1 (``blocks=``: where a moment holds only the rank's
block over the data axes of a parameter the rank holds whole) updates
that block of the parameter from its moment block and the whole
(data-summed) gradient, and all-gathers the blocks over the data axes,
leaf by leaf; ``init(params, blocks=)`` makes such moments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.tree import leaves, tree_map
from repro_torch.parallel.collectives import sum_over, zero1_gather_

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

    def init(self, params, blocks=None) -> AdamWState:
        """Zero moments shaped as the parameters, or, with ``blocks`` (a tree
        of ``ParamSharding`` or None a leaf, ZeRO-1), as each parameter's
        block ``blocks[leaf].local_shape(p.shape)``."""
        blks = [None] * len(leaves(params)) if blocks is None else _leaf_list(blocks, params)

        def zeros():
            it = iter(blks)
            return tree_map(lambda p: torch.zeros(
                (lambda b: p.shape if b is None else b.local_shape(p.shape))(next(it)),
                dtype=torch.float32, device=p.device), params)

        return AdamWState(step=0, mu=zeros(), nu=zeros())

    def _lr(self, step: Tensor) -> Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32, device=step.device)

    def update(self, grads, state: AdamWState, params, *, shardings=None,
               blocks=None, info: Optional[dict] = None) -> Tuple[Any, AdamWState]:
        """One step (module docstring); ``shardings`` and ``blocks`` under
        a mesh. ``info``, where given, receives the step's ``clip_scale``
        (a 0-d tensor; None without clipping)."""
        step = state.step + 1
        with torch.no_grad():
            scale = None
            if self.clip_norm is not None:
                gnorm = global_norm(grads, shardings)
                scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            if info is not None:
                info["clip_scale"] = scale
            b1, b2 = self.b1, self.b2
            mu, nu = leaves(state.mu), leaves(state.nu)
            s = torch.full((), step, dtype=torch.float32, device=mu[0].device)
            bc1 = 1 - b1 ** s
            bc2 = 1 - b2 ** s
            lr = self._lr(s)
            blks = [None] * len(mu) if blocks is None else _leaf_list(blocks, params)
            for p, g, m, v, blk in zip(leaves(params), leaves(grads), mu, nu, blks, strict=True):
                whole = p
                if blk is not None:  # ZeRO-1: the rank's block, then the gather
                    idx = blk.index(p.shape)
                    p, g = p[idx], g[idx]
                if p.is_contiguous():  # m and v are: init made them
                    parts = zip(_chunks(p), g.reshape(-1).split(CHUNK), _chunks(m), _chunks(v))
                elif p.dim() > 1:  # a strided block: a layer at a time
                    parts = [(p[i], g[i], m[i], v[i]) for i in range(p.shape[0])]
                else:
                    parts = [(p, g, m, v)]
                for pc, gc, mc, vc in parts:
                    self._update_chunk(pc, gc, mc, vc, scale, bc1, bc2, lr)
                if blk is not None:
                    zero1_gather_(whole, p, blk.data_dim(), blk.mesh)
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


def global_norm(tree, shardings=None) -> Tensor:
    """sqrt of the sum over leaves of Σ x² (fp32), leaves (and a large
    leaf's chunks) added in order. With ``shardings`` (a tree of
    ``ParamSharding`` matching ``tree``: each leaf is the rank's block)
    the norm of the whole tree over the mesh: a leaf whose block k ranks
    hold alike is weighted 1/k, and one all-reduce over the mesh sums the
    ranks' totals (the same bits on every rank)."""
    total = 0
    shs = [None] * len(leaves(tree)) if shardings is None else _leaf_list(shardings, tree)
    for x, sh in zip(leaves(tree), shs, strict=True):
        k = 1 if sh is None else sh.replicas()
        for c in _chunks(x):
            part = torch.sum(torch.square(c.to(torch.float32)))
            total = total + (part if k == 1 else part / k)
    if shardings is not None and shs and shs[0].mesh.size > 1:
        mesh = shs[0].mesh
        total = sum_over(total, mesh, mesh.axis_names, "clip_norm")
    return torch.sqrt(total)


def _leaf_list(tree, like) -> list:
    """The leaves of ``tree`` (ParamSharding or None a leaf) in the order
    of ``like``'s tensor leaves."""
    if isinstance(like, dict):
        out = []
        for k, v in like.items():
            out.extend(_leaf_list(tree[k], v) if isinstance(v, dict) else [tree[k]])
        return out
    return list(tree)
