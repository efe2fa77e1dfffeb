"""Step functions of the language-model path; port of
``repro/launch/steps.py`` (``make_prefill_step`` and ``make_serve_step``;
``make_train_step`` comes with the training slice).

``make_prefill_step`` returns f(params, batch) → next tokens (B, 1)
int32: the full-sequence forward with the head on the last position
only. ``make_serve_step`` returns f(params, batch, state) →
(next tokens (B, 1) int32, state'), greedy. ``batch`` is a dict with
``"tokens"``, as in the reference. Both run without autograd, in full
fp32 (TF32 off), on ``device``: the card unless the caller asks for the
CPU, and they raise at construction when no card is there.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.precision import pin_full_fp32_math
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, forward
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Batch = Dict[str, Tensor]


def make_serve_step(cfg: ModelConfig, *, device="cuda") -> Callable:
    dev = resolve_device(device)
    pin_full_fp32_math()

    @torch.no_grad()
    def serve_step(params, batch: Batch, state):
        logits, state = decode_step(params, batch["tokens"].to(dev), state, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, use_kernel_ssd: bool = True,
                      last_logits_only: bool = True, device="cuda") -> Callable:
    """Full-sequence forward; ``use_kernel_ssd`` (the default) runs every
    Mamba2 layer's scan through ``kernels.ssd.ops`` (K7 on the card),
    ``False`` through the plain ``ssd_chunked``."""
    dev = resolve_device(device)
    pin_full_fp32_math()

    @torch.no_grad()
    def prefill_step(params, batch: Batch):
        logits, _ = forward(params, batch["tokens"].to(dev), cfg,
                            use_kernel_ssd=use_kernel_ssd,
                            last_logits_only=last_logits_only)
        # the next token after the last position of every sequence
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    return prefill_step
