"""Single-shot trajectory planning on the adaptive solver; port of
``repro/planning/planner.py`` (``NULL_RETURN``, ``PlannerConfig``,
``PlanConditioner``, ``state_pin``, ``plan_conditioner``,
``returns_to_bin``, ``plan``, ``first_action``; the closed-loop
``RecedingHorizonPlanner`` waits for the serving batcher).

Planning is controlled generation over (B, H, D) trajectories
(DESIGN.md §10):

  * current-state conditioning is inpainting along the horizon axis:
    the observation coordinates of the first ``context`` rows are
    observed data, projected after every accepted step and pinned
    exactly at delivery;
  * returns conditioning is classifier-free guidance over discretised
    returns-to-go bins, on a label-aware score (the temporal UNet with
    ``returns_bins > 0``, or the analytic class score);
  * ``PlanConditioner`` composes the two, and ``plan_conditioner``
    builds the (conditioner, payload) pair, ``(None, None)`` when there
    is nothing to condition on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.guidance import ClassifierFree, Inpaint, cond_batch
from repro_torch.core.sampling import sample
from repro_torch.core.solvers import SolveResult
from repro_torch.core.solvers.adaptive import AdaptiveConfig

Tensor = torch.Tensor

#: returns bin meaning "unconditional" (the null CFG branch)
NULL_RETURN = -1


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Trajectory layout and conditioning (DESIGN.md §10).

    Row h of a trajectory is ``[s_h, a_h]``: ``transition_dim = obs_dim
    + act_dim``. The observation coordinates of the first ``context``
    rows are the pinned current state; the executed action is row
    ``context − 1``'s.
    """

    horizon: int = 8
    obs_dim: int = 2
    act_dim: int = 2
    context: int = 1
    #: returns-CFG scale (0 evaluates the null branch only)
    guidance_scale: float = 0.0
    null_label: int = NULL_RETURN

    @property
    def transition_dim(self) -> int:
        return self.obs_dim + self.act_dim

    @property
    def sample_shape(self) -> Tuple[int, int]:
        return (self.horizon, self.transition_dim)


@dataclasses.dataclass(frozen=True)
class PlanConditioner(ClassifierFree):
    """Returns CFG × current-state pinning (DESIGN.md §10). The score
    half is ``ClassifierFree``'s; the projection half is ``Inpaint``'s,
    bit for bit. Payload ``{"label": (B,), "mask", "observed": (B, H, D)}``.
    """

    has_projection = True

    project = Inpaint.project
    finalize_project = Inpaint.finalize_project

    def cond_struct(self, batch: int, sample_shape) -> Any:
        shape = (batch,) + tuple(sample_shape)
        meta = lambda s, dt: torch.empty(s, dtype=dt, device="meta")
        return {"label": meta((batch,), torch.int32),
                "mask": meta(shape, torch.float32),
                "observed": meta(shape, torch.float32)}

    def neutral_cond(self, batch: int, sample_shape) -> Any:
        """The null label and a zero mask: guidance and projection off."""
        shape = (batch,) + tuple(sample_shape)
        return {"label": torch.full((batch,), self.null_label, dtype=torch.int32),
                "mask": torch.zeros(shape), "observed": torch.zeros(shape)}


def state_pin(pcfg: PlannerConfig, state) -> Dict[str, Tensor]:
    """Inpainting payload pinning the current state: mask 1 on the
    observation coordinates of the first ``context`` rows, ``observed``
    holding the state there. ``state`` is (B, obs_dim) (context 1) or
    (B, context, obs_dim); the payload lies on its device."""
    s = torch.as_tensor(state).to(torch.float32)
    if s.ndim == 2:
        s = s[:, None, :]
    b, ctx, od = s.shape
    if ctx != pcfg.context or od != pcfg.obs_dim:
        raise ValueError(f"state {tuple(s.shape[1:])} != (context, obs_dim) "
                         f"({pcfg.context}, {pcfg.obs_dim})")
    shape = (b,) + pcfg.sample_shape
    mask = torch.zeros(shape, dtype=torch.float32, device=s.device)
    observed = torch.zeros(shape, dtype=torch.float32, device=s.device)
    mask[:, :ctx, :od] = 1.0
    observed[:, :ctx, :od] = s
    return {"mask": mask, "observed": observed}


def plan_conditioner(pcfg: PlannerConfig, *, state=None, returns=None):
    """(conditioner, payload) for a planning solve: both None →
    ``(None, None)``; state only → ``Inpaint``; returns only →
    ``ClassifierFree``; both → ``PlanConditioner`` with the merged
    payload. ``returns`` are integer bins (B,)."""
    if state is None and returns is None:
        return None, None
    if returns is None:
        return Inpaint(), state_pin(pcfg, state)
    labels = torch.as_tensor(returns).to(torch.int32)
    scale, null = float(pcfg.guidance_scale), pcfg.null_label
    if state is None:
        return ClassifierFree(scale=scale, null_label=null), {"label": labels}
    return (PlanConditioner(scale=scale, null_label=null),
            {"label": labels, **state_pin(pcfg, state)})


def returns_to_bin(returns, lo: float, hi: float, bins: int) -> Tensor:
    """Discretise returns-to-go into the bins of a returns-aware score
    network (``TemporalUNetConfig.returns_bins``)."""
    r = torch.as_tensor(returns).to(torch.float32)
    idx = torch.floor((r - lo) / (hi - lo) * bins)
    return torch.clamp(idx, 0, bins - 1).to(torch.int32)


def plan(sde, score_fn: Callable, obs, seed: int = 0, *, pcfg: PlannerConfig,
         returns=None, config: Optional[AdaptiveConfig] = None,
         batch: Optional[int] = None, device="cuda",
         noise_fn: Optional[Callable] = None, **overrides) -> SolveResult:
    """One planning solve on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``): (B, H, D) trajectories from the adaptive solver,
    conditioned on the current observations ``obs`` (B, obs_dim) (None
    → unconditional plans, which need ``batch``) and optional returns
    bins. The delivered plans hold ``obs`` exactly in the pinned
    coordinates; ``first_action`` reads the executed action. The score
    must be label-aware (``s(x, t, y)``) when ``returns`` is given.
    ``seed`` seeds the prior and the solver's noise; ``noise_fn``
    replaces the noise draws (``adaptive``'s seam).
    """
    conditioner, cond = plan_conditioner(pcfg, state=obs, returns=returns)
    cfg = config or AdaptiveConfig(eps_rel=0.05)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if conditioner is not None:
        cfg = dataclasses.replace(cfg, conditioner=conditioner)
    if cond is not None:
        payload_batch = cond_batch(cond)
        if batch is not None and batch != payload_batch:
            raise ValueError(f"batch={batch} disagrees with the condition "
                             f"payload's batch dim {payload_batch}")
        batch = payload_batch
    elif batch is None:
        raise ValueError("unconditional plan() needs an explicit batch=")
    return sample(sde, score_fn, (batch,) + pcfg.sample_shape, seed=seed,
                  method="adaptive", config=cfg, cond=cond, device=device,
                  noise_fn=noise_fn)


def first_action(x: Tensor, pcfg: PlannerConfig) -> Tensor:
    """The executed action of a delivered plan: row ``context − 1``'s
    action coordinates. Takes (H, D) or (B, H, D)."""
    row = pcfg.context - 1
    return x[..., row, pcfg.obs_dim: pcfg.obs_dim + pcfg.act_dim]
