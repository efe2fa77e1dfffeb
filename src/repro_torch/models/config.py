"""Model configuration of the language models; port of
``repro/models/config.py`` (data only: no JAX, no weights).

A model is described by a *layer pattern*: the repeating unit of
(mixer, mlp) kinds. ``num_layers`` must be a multiple of the pattern
length; the stack is ``num_layers / len(pattern)`` repeats of the
pattern.

Mixer kinds:  "A" global causal attention · "L" sliding-window attention
              · "X" cross-attention (VLM image layers) · "M" Mamba2 SSD
MLP kinds:    "D" dense MLP · "E" mixture-of-experts · "N" none

The fields and ``scaled_down`` equal the reference's, so a configuration
built here describes the same model there. The port runs every kind
(``models/transformer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ffn: int
    num_shared_experts: int = 0
    shared_ffn: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    padded_experts: int = 0

    @property
    def physical_experts(self) -> int:
        return self.padded_experts or self.num_experts


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        di = self.d_inner(d_model)
        if di % self.head_dim:
            raise ValueError(f"d_inner {di} is not a multiple of head_dim {self.head_dim}")
        return di // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads

    mixer_pattern: Tuple[str, ...] = ("A",)
    mlp_pattern: Tuple[str, ...] = ("D",)

    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 4096
    attn_logit_softcap: float = 0.0

    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_np
    act: str = "silu"
    glu: bool = True

    moe: Optional[MoEConfig] = None
    moe_dispatch: str = "einsum"
    mamba: Optional[MambaConfig] = None
    attn_q_seq_shard: Optional[str] = None
    residual_seq_shard: Optional[str] = None
    decode_flash_shard: Optional[str] = None

    vision_dim: int = 0
    num_patches: int = 0

    num_codebooks: int = 1

    tie_embeddings: bool = False
    dtype: str = "float32"

    source: str = ""

    def __post_init__(self):
        if len(self.mixer_pattern) != len(self.mlp_pattern):
            raise ValueError(f"{self.name}: mixer and mlp patterns differ in length")
        if self.num_layers % len(self.mixer_pattern):
            raise ValueError(f"{self.name}: {self.num_layers} layers not divisible by "
                             f"pattern length {len(self.mixer_pattern)}")
        if self.head_dim == 0:
            if self.num_heads <= 0:
                raise ValueError(f"{self.name}: num_heads must be positive")
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if "E" in self.mlp_pattern and self.moe is None:
            raise ValueError(f"{self.name}: an 'E' layer needs a MoEConfig")
        if "M" in self.mixer_pattern and self.mamba is None:
            raise ValueError(f"{self.name}: an 'M' layer needs a MambaConfig")
        if "X" in self.mixer_pattern and not (self.vision_dim > 0 and self.num_patches > 0):
            raise ValueError(f"{self.name}: an 'X' layer needs vision_dim and num_patches")

    @property
    def num_repeats(self) -> int:
        return self.num_layers // len(self.mixer_pattern)

    @property
    def uses_attention(self) -> bool:
        return any(m in ("A", "L", "X") for m in self.mixer_pattern)

    @property
    def is_subquadratic(self) -> bool:
        return all(m in ("M", "L") for m in self.mixer_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def scaled_down(self) -> "ModelConfig":
        """Reduced variant of the same family for CPU tests: pattern
        preserved, one pattern repeat, d_model ≤ 256, ≤ 4 experts (the
        reference's values field for field)."""
        period = len(self.mixer_pattern)
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        while num_heads % num_kv:
            num_kv -= 1
        head_dim = max(8, d_model // num_heads)
        kw = dict(
            num_layers=period,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16),
            dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_ffn=min(self.moe.expert_ffn, 64),
                shared_ffn=min(self.moe.shared_ffn, 64) if self.moe.shared_ffn else 0,
            )
        if self.mamba is not None:
            kw["mamba"] = dataclasses.replace(
                self.mamba, d_state=min(self.mamba.d_state, 32), head_dim=32
            )
        if self.vision_dim:
            kw["vision_dim"] = min(self.vision_dim, 64)
            kw["num_patches"] = min(self.num_patches, 16)
        return self.replace(**kw)
