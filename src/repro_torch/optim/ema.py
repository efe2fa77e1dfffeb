"""Exponential moving average of parameters; port of
``repro/optim/ema.py`` (the paper samples from the EMA weights of the
score net)."""

from __future__ import annotations

import torch

from repro_torch.optim.tree import tree_map


def ema_init(params):
    """fp32 copies of ``params``, cut from autograd."""
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)


def ema_update(ema, params, decay: float = 0.999):
    """decay·e + (1 − decay)·p, in fp32, as new tensors."""
    with torch.no_grad():
        return tree_map(lambda e, p: decay * e + (1.0 - decay) * p.to(torch.float32),
                        ema, params)


def ema_params(ema, like):
    """The fp32 EMA cast back to the dtypes of ``like``."""
    return tree_map(lambda e, p: e.to(p.dtype), ema, like)
