"""Precision policy; port of ``repro/core/precision.py`` (DESIGN.md §8).

``PrecisionPolicy`` names one dtype per seam:

  * ``compute`` — network activations and the weight copies the
    matmuls consume;
  * ``param``   — stored ("master") weights;
  * ``state``   — the solver carry's x / x_prev;
  * ``control`` — t / h / δ / error / accept arithmetic, always fp32
    (there is no knob to lower it).

  ========== ========= ========= =========
  preset     compute   param     state
  ========== ========= ========= =========
  fp32       float32   float32   float32
  bf16       bfloat16  float32   float32
  bf16_full  bfloat16  bfloat16  bfloat16
  ========== ========= ========= =========

A policy is a preset with optional per-seam overrides
(``PrecisionPolicy("bf16", state_dtype="bfloat16")``), each a
``torch.dtype`` or the reference's name (``"bfloat16"``). ``name`` is
derived from the three dtypes: the preset they match, else ``"custom"``
(so ``PrecisionPolicy("fp32", compute_dtype="bfloat16").name`` is
``"bf16"``, as in the reference).

TF32: building a policy, under every preset, sets both
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. cuDNN's default is True,
and TF32 keeps about three decimal digits, so an fp32 preset would
otherwise not be fp32 on the card. The flags are process-wide and no
preset wants TF32, so setting them is idempotent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

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


def to_dtype(d) -> torch.dtype:
    """A ``torch.dtype`` from itself or its name (``"bfloat16"``,
    ``"torch.bfloat16"``)."""
    if isinstance(d, torch.dtype):
        return d
    got = getattr(torch, str(d).removeprefix("torch."), None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"not a dtype: {d!r}")
    return got


def dtype_name(d: torch.dtype) -> str:
    """The reference's name of a dtype (``"bfloat16"``)."""
    return str(d).removeprefix("torch.")


@dataclasses.dataclass(frozen=True, init=False)
class PrecisionPolicy:
    """Which dtype lives at which seam. ``control`` cannot be lowered."""

    compute: torch.dtype
    param: torch.dtype
    state: torch.dtype
    control: torch.dtype

    def __init__(self, preset: str = "fp32", *, compute_dtype=None, param_dtype=None,
                 state_dtype=None):
        if preset not in PRESETS:
            raise ValueError(
                f"unknown precision preset {preset!r}; have {sorted(PRESETS)}")
        c, p, s = PRESETS[preset]
        pick = lambda override, default: default if override is None else to_dtype(override)
        object.__setattr__(self, "compute", pick(compute_dtype, c))
        object.__setattr__(self, "param", pick(param_dtype, p))
        object.__setattr__(self, "state", pick(state_dtype, s))
        object.__setattr__(self, "control", torch.float32)
        pin_full_fp32_math()

    # --- the reference's names of the seams' dtypes --------------------
    @property
    def compute_dtype(self) -> str:
        return dtype_name(self.compute)

    @property
    def param_dtype(self) -> str:
        return dtype_name(self.param)

    @property
    def state_dtype(self) -> str:
        return dtype_name(self.state)

    @property
    def control_dtype(self) -> str:
        return dtype_name(self.control)

    @property
    def name(self) -> str:
        """The preset whose dtypes these are, else ``"custom"``."""
        mine = (self.compute, self.param, self.state)
        return next((p for p, dts in PRESETS.items() if dts == mine), "custom")

    @property
    def is_fp32(self) -> bool:
        return self.name == "fp32"

    # --- casts ----------------------------------------------------------
    def to_compute(self, x: Tensor) -> Tensor:
        return x.to(self.compute)

    def to_state(self, x: Tensor) -> Tensor:
        return x.to(self.state)

    def to_control(self, x: Tensor) -> Tensor:
        return x.to(self.control)

    def cast_params(self, params):
        """Floating leaves → ``param`` (the stored weights).

        An ``nn.Module`` is cast in place (its floating parameters and
        buffers; no second copy of the weights is kept) and returned. A
        nested mapping of tensors (the LMs' parameter trees) is returned
        as a new tree of the same keys. Integer leaves pass untouched, and
        a leaf already of the dtype is returned as it is, with no copy.
        """
        if isinstance(params, nn.Module):
            return params.to(self.param)
        return _cast_tree(params, self.param)

    def params_for_compute(self, params):
        """Floating leaves → ``compute``: the copies the matmuls consume.
        A mapping gives a tree of the same keys; an ``nn.Module`` gives
        ``{name: leaf}`` over its named parameters, its stored weights
        untouched. Leaves already of the dtype are not copied."""
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        return _cast_tree(params, self.compute)

    def wrap_score_fn(self, score_fn: Callable) -> Callable:
        """x → compute dtype on entry, score → state dtype on exit; t is
        control data and passes untouched. No-op casts under fp32."""

        def wrapped(x: Tensor, t: Tensor) -> Tensor:
            return score_fn(self.to_compute(x), t).to(self.state)

        return wrapped

    def as_dict(self) -> Dict[str, object]:
        """JSON-friendly record of the policy (the reference's keys)."""
        return {"policy": self.name, "compute_dtype": self.compute_dtype,
                "param_dtype": self.param_dtype, "state_dtype": self.state_dtype,
                "control_dtype": self.control_dtype,
                "compute_itemsize": self.compute.itemsize,
                "param_itemsize": self.param.itemsize,
                "state_itemsize": self.state.itemsize}


def _cast_tree(tree, dtype: torch.dtype):
    if isinstance(tree, Mapping):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, Tensor) and tree.is_floating_point():
        return tree.to(dtype)  # the same tensor where it already has the dtype
    return tree


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
