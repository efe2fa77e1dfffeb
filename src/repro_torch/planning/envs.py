"""Analytic environments for the receding-horizon planner (DESIGN.md
§10); port of ``repro/planning/envs.py``.

No simulator: both environments are a few lines of closed-form dynamics
on the host, in fp32, ``reset(generator) -> obs`` and ``step(obs, action,
generator) -> (obs, reward)``; the state is the observation.

  * ``OUEnv``: a controlled Ornstein–Uhlenbeck process, the action added
    to the mean-reverting drift, Brownian noise. Its stationary law is
    the Gaussian family the analytic trajectory score models.
  * ``PointMassEnv``: a deterministic double integrator (position and
    velocity, acceleration as the action) steering to a goal.

Noise: ``generator`` is a ``torch.Generator`` (a CPU one: observations
live on the host), or, the seam through which tests hand in the
reference's own draws (JAX's threefry and torch never agree), a callable
``source(shape) -> Tensor`` asked for each draw in the order the
environment draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


def _normal(generator, shape) -> Tensor:
    """fp32 N(0, I) of ``shape`` from a ``torch.Generator`` or a replay
    source."""
    if callable(generator):
        return torch.as_tensor(generator(tuple(shape))).to(torch.float32)
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32)


def _f32(v) -> Tensor:
    return torch.as_tensor(v).to(dtype=torch.float32, device="cpu")


@dataclasses.dataclass(frozen=True)
class OUEnv:
    """Controlled OU process: ds = (−θ·s + a)·dt + σ·√dt·z. The reward is
    the negative quadratic state and action cost: hold the state near 0
    with small actions."""

    obs_dim: int = 2
    theta: float = 1.0
    sigma: float = 0.2
    dt: float = 0.1
    act_cost: float = 0.1

    @property
    def act_dim(self) -> int:
        return self.obs_dim  # one actuator a state coordinate

    def reset(self, generator) -> Tensor:
        return self.sigma * _normal(generator, (self.obs_dim,))

    def step(self, obs, action, generator):
        obs, action = _f32(obs), _f32(action)
        z = _normal(generator, (self.obs_dim,))
        # σ·√dt rounded in fp32 first, as the reference's weak-typed scalars
        noise = self.sigma * torch.sqrt(torch.tensor(self.dt, dtype=torch.float32))
        nxt = obs + self.dt * (-self.theta * obs + action) + noise * z
        reward = -((nxt * nxt).sum() + self.act_cost * (action * action).sum())
        return nxt, float(reward)


@dataclasses.dataclass(frozen=True)
class PointMassEnv:
    """Deterministic double integrator: obs = [pos, vel], action = accel.
    The reward is the negative squared distance to ``goal`` plus a small
    velocity penalty, so the optimum parks there."""

    dim: int = 2
    dt: float = 0.1
    #: None is the origin in ``dim`` dimensions
    goal: Optional[tuple] = None
    vel_cost: float = 0.05

    @property
    def obs_dim(self) -> int:
        return 2 * self.dim

    @property
    def act_dim(self) -> int:
        return self.dim

    def reset(self, generator) -> Tensor:
        pos = _normal(generator, (self.dim,))
        return torch.cat([pos, torch.zeros(self.dim)])

    def step(self, obs, action, generator=None):
        del generator  # deterministic
        obs, action = _f32(obs), _f32(action)
        pos, vel = obs[: self.dim], obs[self.dim:]
        pos = pos + self.dt * vel
        vel = vel + self.dt * action
        goal = torch.zeros(self.dim) if self.goal is None else _f32(self.goal)
        err = pos - goal
        reward = -((err * err).sum() + self.vel_cost * (vel * vel).sum())
        return torch.cat([pos, vel]), float(reward)


ENVS = {"ou": OUEnv, "pointmass": PointMassEnv}


def get_env(name: str, **kw):
    name = name.lower()
    if name not in ENVS:
        raise ValueError(f"unknown env {name!r}; have {sorted(ENVS)}")
    return ENVS[name](**kw)
