"""Port of ``repro/serving``: the continuous-batching diffusion server
(``diffusion_server.py``) and the serving-stage policies
(``scheduler.py``). The LM decode scheduler waits for ROADMAP A12."""

from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest
from repro_torch.serving.scheduler import (
    AdmissionPolicy, EdfPriorityAdmission, FifoAdmission, TierAccounting, TierStats,
    tier_name,
)

__all__ = [
    "AdmissionPolicy", "DiffusionBatcher", "EdfPriorityAdmission", "FifoAdmission",
    "ImageRequest", "TierAccounting", "TierStats", "tier_name",
]
