"""Port of ``repro/optim``: AdamW with global-norm clipping, the EMA of
parameters and the learning-rate schedules, as plain functions over a
list or a dict of tensors (an ``nn.Module``'s parameters are one such
list)."""

from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim.ema import ema_init, ema_params, ema_update
from repro_torch.optim.schedules import constant, warmup_cosine, warmup_linear

__all__ = [
    "AdamW", "AdamWState", "global_norm",
    "ema_init", "ema_params", "ema_update",
    "constant", "warmup_cosine", "warmup_linear",
]
