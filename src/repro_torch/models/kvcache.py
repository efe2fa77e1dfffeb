"""Recurrent decode state of the Mamba2 layers; port of the SSM half of
``repro/models/kvcache.py`` (``MambaState``, ``init_mamba_state``).

The attention archs' ``LayerKVCache`` comes with them (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class MambaState:
    conv: Tensor  # (B, conv_width-1, channels) rolling conv inputs, model dtype
    ssm: Tensor   # (B, H, N, P) fp32 recurrent state


def init_mamba_state(batch: int, conv_width: int, channels: int, heads: int,
                     d_state: int, head_dim: int, dtype=torch.float32,
                     device="cpu") -> MambaState:
    return MambaState(
        conv=torch.zeros(batch, conv_width - 1, channels, dtype=dtype, device=device),
        ssm=torch.zeros(batch, heads, d_state, head_dim, dtype=torch.float32,
                        device=device),
    )
