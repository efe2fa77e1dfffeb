"""Trajectory-diffusion planning; port of ``repro/planning`` (DESIGN.md
§10): returns- and state-conditioned plan generation on the §9
conditioning seam. The receding-horizon planner, its analytic
environments and its launcher ride on the serving batcher and are not
ported yet."""

from repro_torch.planning.planner import (
    NULL_RETURN,
    PlanConditioner,
    PlannerConfig,
    first_action,
    plan,
    plan_conditioner,
    returns_to_bin,
    state_pin,
)

__all__ = [
    "NULL_RETURN", "PlanConditioner", "PlannerConfig", "first_action",
    "plan", "plan_conditioner", "returns_to_bin", "state_pin",
]
