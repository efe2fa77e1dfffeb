"""Port of ``repro/configs``: the diffusion configurations
(``configs/diffusion.py``) and the registry of language-model
architectures, ``get_config(arch_id)``.

The registry holds the architectures the port can run. The reference's
other architectures have attention, experts or codebook heads, which
come with ROADMAP item A12; asking for one raises and says so.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import mamba2_2_7b

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (mamba2_2_7b,)}

ARCH_IDS = tuple(sorted(_REGISTRY))

#: the reference's architectures that the port does not run yet
NOT_PORTED = ("deepseek-moe-16b", "gemma3-12b", "granite-moe-3b-a800m",
              "jamba-v0.1-52b", "llama-3.2-vision-90b", "musicgen-medium",
              "olmo-1b", "qwen1.5-0.5b", "qwen3-14b")


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"arch '{name}' is not ported yet (attention, MoE and codebook "
                f"architectures come with ROADMAP A12); have {list(ARCH_IDS)}") from None
        raise ValueError(f"unknown arch '{name}'; have {list(ARCH_IDS)}") from None


__all__ = ["ARCH_IDS", "NOT_PORTED", "get_config"]
