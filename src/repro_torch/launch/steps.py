"""Step functions of the language-model path; port of
``repro/launch/steps.py`` (``make_prefill_step`` and ``make_serve_step``;
``make_train_step`` comes with the training slice).

``make_prefill_step`` returns f(params, batch) → next tokens (B, 1)
int32: the full-sequence forward with the head on the last position
only. ``make_serve_step`` returns f(params, batch, state) →
(next tokens (B, 1) int32, state'), greedy. ``batch`` is a dict with
``"tokens"`` and, for continuous batching, ``"start_pos"`` (B,), as in
the reference. Both run without autograd, in full
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
        start_pos = batch.get("start_pos")
        logits, state = decode_step(params, batch["tokens"].to(dev), state, cfg,
                                    start_pos=None if start_pos is None else start_pos.to(dev))
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = True,
                      use_kernel_ssd: bool = True, last_logits_only: bool = True,
                      device="cuda") -> Callable:
    """Full-sequence forward (reference :77); ``use_flash`` (the default)
    runs every attention layer through ``kernels.flash_attention.ops``
    (K3 on the card), ``use_kernel_ssd`` (the default) every Mamba2
    layer's scan through ``kernels.ssd.ops`` (K7 on the card); ``False``
    takes the plain path."""
    dev = resolve_device(device)
    pin_full_fp32_math()

    @torch.no_grad()
    def prefill_step(params, batch: Batch):
        logits, _ = forward(params, batch["tokens"].to(dev), cfg,
                            use_kernel_ssd=use_kernel_ssd, use_flash=use_flash,
                            last_logits_only=last_logits_only)
        # the next token after the last position of every sequence
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    return prefill_step
