"""Port of ``repro/configs``: the diffusion configurations
(``configs/diffusion.py``), the registry of language-model
architectures, ``get_config(arch_id)``, and the input shapes with their
per-architecture policy (``configs/shapes.py``).

The registry holds every architecture of the reference: the dense
attention models (olmo-1b, qwen1.5-0.5b, qwen3-14b, gemma3-12b),
mamba2-2.7b, the mixture-of-experts models (deepseek-moe-16b,
granite-moe-3b-a800m), the hybrid jamba-v0.1-52b, the vision-language
llama-3.2-vision-90b (cross-attention) and the audio musicgen-medium
(four codebooks).
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (
    deepseek_moe_16b,
    gemma3_12b,
    granite_moe_3b_a800m,
    jamba_v0_1_52b,
    llama3_2_vision_90b,
    mamba2_2_7b,
    musicgen_medium,
    olmo_1b,
    qwen1_5_0_5b,
    qwen3_14b,
)
from .shapes import (
    LONG_CONTEXT_SWA_WINDOW,
    SHAPES,
    InputShape,
    apply_shape_policy,
    get_shape,
    needs_swa_override,
)

_REGISTRY = {m.CONFIG.name: m.CONFIG
             for m in (olmo_1b, qwen1_5_0_5b, qwen3_14b, gemma3_12b, mamba2_2_7b,
                       deepseek_moe_16b, granite_moe_3b_a800m, jamba_v0_1_52b,
                       llama3_2_vision_90b, musicgen_medium)}

ARCH_IDS = tuple(sorted(_REGISTRY))

#: the reference's architectures that the port does not run: none
NOT_PORTED = ()


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown arch '{name}'; have {list(ARCH_IDS)}") from None


__all__ = [
    "ARCH_IDS",
    "InputShape",
    "LONG_CONTEXT_SWA_WINDOW",
    "NOT_PORTED",
    "SHAPES",
    "apply_shape_policy",
    "get_config",
    "get_shape",
    "needs_swa_override",
]
