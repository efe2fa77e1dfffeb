"""Trajectory-diffusion planning; port of ``repro/planning`` (DESIGN.md
§10): returns- and state-conditioned plan generation on the §9
conditioning seam, the analytic environments, and the receding-horizon
closed loop served through the §7 ``DiffusionBatcher``."""

from repro_torch.planning.envs import ENVS, OUEnv, PointMassEnv, get_env
from repro_torch.planning.planner import (
    NULL_RETURN,
    PlanConditioner,
    PlannerConfig,
    PlanRequest,
    RecedingHorizonPlanner,
    first_action,
    plan,
    plan_conditioner,
    returns_to_bin,
    state_pin,
)

__all__ = [
    "ENVS", "OUEnv", "PointMassEnv", "get_env",
    "NULL_RETURN", "PlanConditioner", "PlannerConfig", "PlanRequest",
    "RecedingHorizonPlanner", "first_action", "plan", "plan_conditioner",
    "returns_to_bin", "state_pin",
]
