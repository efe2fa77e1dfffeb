"""Port of ``repro/data`` (the synthetic image data; the token pipeline
is not ported yet, ROADMAP A12)."""

from repro_torch.data.images import (
    GMM2D, GMMImageConfig, data_moments, generator_params, sample_images,
)

__all__ = ["GMM2D", "GMMImageConfig", "data_moments", "generator_params",
           "sample_images"]
