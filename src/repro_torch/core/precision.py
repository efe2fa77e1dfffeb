"""Precision policy; port of ``repro/core/precision.py`` (DESIGN.md §8).

``PrecisionPolicy`` names one dtype per seam:

  * ``compute`` — network activations and the weight copies the
    matmuls consume;
  * ``param``   — stored weights;
  * ``state``   — the solver carry's x / x_prev;
  * ``control`` — t / h / δ / error / accept arithmetic, always fp32.

  ========== ========= ========= =========
  preset     compute   param     state
  ========== ========= ========= =========
  fp32       float32   float32   float32
  bf16       bfloat16  float32   float32
  bf16_full  bfloat16  bfloat16  bfloat16
  ========== ========= ========= =========

TF32: building a policy, under every preset, sets both
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. cuDNN's default is True,
and TF32 keeps about three decimal digits, so an fp32 preset would
otherwise not be fp32 on the card. The flags are process-wide and no
preset wants TF32, so setting them is idempotent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

Tensor = torch.Tensor

#: preset → (compute, param, state)
PRESETS: Dict[str, tuple] = {
    "fp32": (torch.float32, torch.float32, torch.float32),
    "bf16": (torch.bfloat16, torch.float32, torch.float32),
    "bf16_full": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
}


def pin_full_fp32_math() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True, init=False)
class PrecisionPolicy:
    """Which dtype lives at which seam. ``control`` cannot be lowered."""

    name: str
    compute: torch.dtype
    param: torch.dtype
    state: torch.dtype
    control: torch.dtype

    def __init__(self, preset: str = "fp32"):
        if preset not in PRESETS:
            raise ValueError(
                f"unknown precision preset {preset!r}; have {sorted(PRESETS)}")
        c, p, s = PRESETS[preset]
        object.__setattr__(self, "name", preset)
        object.__setattr__(self, "compute", c)
        object.__setattr__(self, "param", p)
        object.__setattr__(self, "state", s)
        object.__setattr__(self, "control", torch.float32)
        pin_full_fp32_math()

    def to_compute(self, x: Tensor) -> Tensor:
        return x.to(self.compute)

    def to_state(self, x: Tensor) -> Tensor:
        return x.to(self.state)

    def as_dict(self) -> Dict[str, object]:
        """JSON-friendly record of the policy (the reference's keys)."""
        name = lambda d: str(d).removeprefix("torch.")
        return {"policy": self.name, "compute_dtype": name(self.compute),
                "param_dtype": name(self.param), "state_dtype": name(self.state),
                "control_dtype": name(self.control),
                "compute_itemsize": self.compute.itemsize,
                "param_itemsize": self.param.itemsize,
                "state_itemsize": self.state.itemsize}

    def wrap_score_fn(self, score_fn: Callable) -> Callable:
        """x → compute dtype on entry, score → state dtype on exit; t is
        control data and passes untouched. No-op casts under fp32."""

        def wrapped(x: Tensor, t: Tensor) -> Tensor:
            return score_fn(self.to_compute(x), t).to(self.state)

        return wrapped


def resolve_policy(policy: Optional[object]) -> PrecisionPolicy:
    """None | preset name | PrecisionPolicy → PrecisionPolicy."""
    if policy is None:
        return PrecisionPolicy("fp32")
    if isinstance(policy, PrecisionPolicy):
        return policy
    if isinstance(policy, str):
        return PrecisionPolicy(policy)
    raise TypeError(
        f"precision must be a preset name or PrecisionPolicy, got {policy!r}")
