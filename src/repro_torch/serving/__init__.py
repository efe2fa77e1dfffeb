"""Port of ``repro/serving``: the continuous-batching diffusion server
(``diffusion_server.py``), the serving-stage policies and the LM decode
scheduler ``ContinuousBatcher`` (``scheduler.py``)."""

from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest
from repro_torch.serving.scheduler import (
    AdmissionPolicy, ContinuousBatcher, EdfPriorityAdmission, FifoAdmission, Request,
    TierAccounting, TierStats, tier_name,
)

__all__ = [
    "AdmissionPolicy", "ContinuousBatcher", "DiffusionBatcher", "EdfPriorityAdmission",
    "FifoAdmission", "ImageRequest", "Request", "TierAccounting", "TierStats", "tier_name",
]
