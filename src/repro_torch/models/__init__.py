"""Port of ``repro/models``: the score networks (the DiT, the temporal
UNet), the language models and the diffusion LM, with the exports of
the reference's ``repro.models`` and the attention layers' decode
pieces."""

from repro_torch.models.attention import attention_decode, attention_forward
from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig
from repro_torch.models.kvcache import LayerKVCache, init_kv_cache
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_model,
)

__all__ = [
    "LayerKVCache", "MambaConfig", "ModelConfig", "MoEConfig",
    "attention_decode", "attention_forward", "decode_step", "forward",
    "init_decode_state", "init_kv_cache", "init_model",
]
