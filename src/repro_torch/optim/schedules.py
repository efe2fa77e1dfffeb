"""Learning-rate schedules (callables step → lr as a 0-d fp32 tensor);
port of ``repro/optim/schedules.py``. ``step`` is an int or a tensor."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=_f32(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak_lr * (1 - progress))

    return fn
