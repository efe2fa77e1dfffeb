"""Score-network configurations and tolerance classes; the port's own copy
of the parts of ``repro/configs/diffusion.py`` this slice runs.

``CIFAR_DIT`` (and the image UNet ``CIFAR_UNET``) mirrors the paper's
CIFAR-10 32×32 setting at a trainable scale; ``HIGHRES_DIT`` stands in for its 256×256 setting (Table 2): 256
tokens of 16×16 patches, d_model 768, 12 layers, 12 heads of width 64,
d_ff 3072, 159.1 M parameters. ``DIT_100M`` is the reference's
~100 M-parameter end-to-end preset. ``TOY_MLP`` is the score net of the
exactly solvable 2-D mixture of Tables 1, 3 and 4–5. ``TRAJ_UNET`` is the trajectory
workload's temporal score network (DESIGN.md §10): horizon-32 plans of
a locomotion-style transition (obs 17 + act 6 = 23) with returns-to-go
CFG bins. The tolerance classes name points on
the paper's Table-1 ε frontier (DESIGN.md §14).
"""

import dataclasses
from typing import Optional

from repro_torch.models.dit import DiTConfig
from repro_torch.models.score_unet import MLPScoreConfig, UNetConfig
from repro_torch.models.temporal_unet import TemporalUNetConfig


@dataclasses.dataclass(frozen=True)
class ToleranceClass:
    """A per-request quality tier: the adaptive solver's tolerance.

    ``eps_abs=None`` defers to ``sde.abs_tolerance``; ``h_init=None`` to
    the solver config's ``h_init``. ``deadline_ms`` and ``priority`` are
    the tier's serving defaults (lower priority = more urgent).
    """

    name: str
    eps_rel: float
    eps_abs: Optional[float] = None
    h_init: Optional[float] = None
    deadline_ms: Optional[float] = None
    priority: int = 0


DRAFT = ToleranceClass("draft", eps_rel=0.5, priority=1)
STANDARD = ToleranceClass("standard", eps_rel=0.05, priority=1)
HIGH_FIDELITY = ToleranceClass("high_fidelity", eps_rel=0.01, priority=0)

TOLERANCE_CLASSES = {c.name: c for c in (DRAFT, STANDARD, HIGH_FIDELITY)}


def resolve_tier(tier) -> ToleranceClass:
    """Preset name or ToleranceClass instance → ToleranceClass."""
    if isinstance(tier, ToleranceClass):
        return tier
    if tier in TOLERANCE_CLASSES:
        return TOLERANCE_CLASSES[tier]
    raise KeyError(f"unknown tolerance class {tier!r}; presets: "
                   f"{sorted(TOLERANCE_CLASSES)} (or pass a ToleranceClass)")

CIFAR_DIT = DiTConfig(
    image_size=32, channels=3, patch=4, d_model=256, num_layers=6,
    num_heads=8, d_ff=1024,
)
CIFAR_UNET = UNetConfig(image_size=32, channels=3, base=32, mults=(1, 2, 2))

HIGHRES_DIT = DiTConfig(
    image_size=256, channels=3, patch=16, d_model=768, num_layers=12,
    num_heads=12, d_ff=3072,
)

DIT_100M = DiTConfig(
    image_size=32, channels=3, patch=2, d_model=768, num_layers=12,
    num_heads=12, d_ff=3072,
)

TOY_MLP = MLPScoreConfig(dim=2, hidden=128, depth=3)

TRAJ_UNET = TemporalUNetConfig(
    horizon=32, transition_dim=23, base=32, mults=(1, 2, 4), t_dim=64,
    returns_bins=10,
)

#: the DiT presets the sampling launcher takes by name
ARCHS = {"cifar_dit": CIFAR_DIT, "highres_dit": HIGHRES_DIT,
         "dit_100m": DIT_100M}
