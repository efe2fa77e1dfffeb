"""Port of ``repro/models``: the score networks (the DiT, the temporal
UNet) and the language models, with the exports of the reference's
``repro.models``."""

from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_model,
)

__all__ = [
    "MambaConfig", "ModelConfig", "MoEConfig",
    "decode_step", "forward", "init_decode_state", "init_model",
]
