"""Port of ``repro/models``: the score networks (the DiT, the temporal
UNet), the language models and the diffusion LM, with the exports of
the reference's ``repro.models``, the attention layers' decode pieces
and the mixture-of-experts MLP."""

from repro_torch.models.attention import attention_decode, attention_forward
from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig
from repro_torch.models.kvcache import LayerKVCache, init_kv_cache
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_model,
    shard_params,
)

__all__ = [
    "LayerKVCache", "MambaConfig", "ModelConfig", "MoEConfig",
    "apply_moe", "attention_decode", "attention_forward", "decode_step", "forward",
    "init_decode_state", "init_kv_cache", "init_model", "init_moe", "shard_params",
]
