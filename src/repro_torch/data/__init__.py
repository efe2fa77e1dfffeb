"""Port of ``repro/data``: the synthetic image data and the synthetic
token pipeline of LM training."""

from repro_torch.data.images import (
    GMM2D, GMMImageConfig, data_moments, generator_params, sample_images,
)
from repro_torch.data.tokens import (
    TokenPipelineConfig, apply_delay_pattern, batches, lm_loss, synth_batch,
)

__all__ = ["GMM2D", "GMMImageConfig", "TokenPipelineConfig", "apply_delay_pattern",
           "batches", "data_moments", "generator_params", "lm_loss", "sample_images",
           "synth_batch"]
