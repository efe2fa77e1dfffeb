"""Receding-horizon trajectory planning on the adaptive solver; port of
``repro/planning/planner.py``.

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

``plan`` is the single-shot form, one adaptive solve a call.
``RecedingHorizonPlanner`` is the closed loop: plans are ordinary
requests (``PlanRequest``) of a ``DiffusionBatcher`` (DESIGN.md §7), each
environment executes the first action of its delivered plan, and the
re-conditioned request (the new state pinned, a fresh uid and seed)
queues again. A request's noise is its own stream, and compaction moves
payloads with their samples, so a delivered plan is bitwise its
standalone ``adaptive()`` solve of the same (seed, payload), whichever
slot it took and whichever environments shared the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.guidance import ClassifierFree, Inpaint, cond_batch
from repro_torch.core.sampling import sample
from repro_torch.core.solvers import SolveResult
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

Tensor = torch.Tensor

#: a plan request is an ordinary batcher request: the same queue, slots
#: and compaction (DESIGN.md §10)
PlanRequest = ImageRequest

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
         noise_fn: Optional[Callable] = None, mesh=None, **overrides) -> SolveResult:
    """One planning solve on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``): (B, H, D) trajectories from the adaptive solver,
    conditioned on the current observations ``obs`` (B, obs_dim) (None
    → unconditional plans, which need ``batch``) and optional returns
    bins. The delivered plans hold ``obs`` exactly in the pinned
    coordinates; ``first_action`` reads the executed action. The score
    must be label-aware (``s(x, t, y)``) when ``returns`` is given.
    ``seed`` seeds the prior and the solver's noise; ``noise_fn``
    replaces the noise draws (``adaptive``'s seam). ``mesh`` makes the
    solve data-parallel (``sample(mesh=)``): the result holds this rank's
    rows (``sampling.gather_result`` collects them).
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
                  noise_fn=noise_fn, mesh=mesh)


def first_action(x: Tensor, pcfg: PlannerConfig) -> Tensor:
    """The executed action of a delivered plan: row ``context − 1``'s
    action coordinates. Takes (H, D) or (B, H, D)."""
    row = pcfg.context - 1
    return x[..., row, pcfg.obs_dim: pcfg.obs_dim + pcfg.act_dim]


class RecedingHorizonPlanner:
    """Closed-loop planner serving on the diffusion batcher (DESIGN.md §10).

    Each environment's plan is a ``PlanRequest`` in a ``DiffusionBatcher``
    whose conditioner is a ``PlanConditioner`` (unless ``cfg`` brings its
    own). One control round: every environment submits a request pinning
    its current observation (and carrying its returns bin); the batcher
    drains, retiring converged plans at sync horizons, compacting and
    admitting queued requests into freed slots (more environments than
    slots queue for real); each environment executes ``first_action`` of
    its delivered plan, and the re-conditioned request enters the next
    round.

    ``forward_fn(params, x, t, y=None)`` predicts noise (score = −out/std),
    label-aware when returns guidance is on; the device step is built here
    from the same final ``cfg`` the batcher gets. ``device`` holds the
    batcher (``cuda`` unless the caller passes ``"cpu"``);
    ``request_streams`` is the batcher's seam (tests hand in the
    reference's per-request draws). ``mesh=`` shards the batcher's slots
    over the mesh's data axes (``DiffusionBatcher(mesh=)``): every rank
    of the mesh builds the planner and runs the same rollout, and each
    environment steps on every rank with the plan all of them deliver.
    """

    def __init__(self, sde, forward_fn, params, pcfg: PlannerConfig, env, *,
                 cfg: Optional[AdaptiveConfig] = None, slots: int = 4,
                 sync_horizon: int = 4, compaction: bool = True, mesh=None,
                 tracer=None, device="cuda", request_streams: Optional[Callable] = None):
        from repro_torch.launch.sample import make_sample_step

        self.pcfg = pcfg
        self.env = env
        if env.obs_dim != pcfg.obs_dim or env.act_dim != pcfg.act_dim:
            raise ValueError(f"env dims ({env.obs_dim}, {env.act_dim}) != planner "
                             f"({pcfg.obs_dim}, {pcfg.act_dim})")
        base = cfg or AdaptiveConfig(eps_rel=0.05)
        if base.conditioner is None:
            base = dataclasses.replace(base, conditioner=PlanConditioner(
                scale=float(pcfg.guidance_scale), null_label=pcfg.null_label))
        self.cfg = base
        # one step for the batcher, from the cfg it gets: a step built
        # without the conditioner would skip the in-loop projection while
        # delivery still pinned
        sample_step = make_sample_step(sde, base, forward_fn=forward_fn)
        self.batcher = DiffusionBatcher(
            sde, sample_step, params, pcfg.sample_shape, slots=slots, cfg=base, mesh=mesh,
            sync_horizon=sync_horizon, compaction=compaction, tracer=tracer,
            device=device, request_streams=request_streams)
        self._uid = 0

    def request_cond(self, obs, returns_label: Optional[int] = None) -> Dict[str, Tensor]:
        """One request's unbatched payload rows, with exactly the keys of
        the server conditioner's ``cond_struct``: the pin of this
        environment's state and its returns bin (None is the null label)."""
        struct = self.cfg.conditioner.cond_struct(1, self.pcfg.sample_shape)
        if returns_label is not None and "label" not in struct:
            raise ValueError(
                f"returns_label={returns_label} given but the server conditioner "
                f"{type(self.cfg.conditioner).__name__} carries no label payload: the "
                "guidance would be silently dropped")
        pin = state_pin(self.pcfg, torch.as_tensor(obs)[None])
        label = self.pcfg.null_label if returns_label is None else int(returns_label)
        rows = {"label": torch.tensor(label, dtype=torch.int32),
                **{k: v[0] for k, v in pin.items()}}
        unknown = set(struct) - set(rows)
        if unknown:
            raise ValueError(f"server conditioner declares payload keys {sorted(unknown)} "
                             f"the planner cannot fill (have {sorted(rows)})")
        return {k: rows[k] for k in struct}

    def rollout(self, generator=0, *, n_envs: int, n_steps: int,
                returns_label: Optional[int] = None, seed0: int = 0) -> Dict[str, Any]:
        """Run ``n_envs`` environments for ``n_steps`` control rounds through
        the shared batcher; returns the rewards and per-request NFE
        (n_steps, n_envs), the delivered requests and the batcher's waste
        books. ``generator`` (a CPU ``torch.Generator``, an int seed, or a
        replay source, ``envs``) draws every environment's reset, then
        their steps' noise in round and environment order."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        obs = [self.env.reset(generator) for _ in range(n_envs)]
        rewards = np.zeros((n_steps, n_envs))
        nfes = np.zeros((n_steps, n_envs), np.int64)
        for round_i in range(n_steps):
            with self.batcher.tracer.span("plan/round", round=round_i, envs=n_envs) as sp:
                uids = []
                for i in range(n_envs):
                    uid = seed0 + self._uid
                    self._uid += 1
                    self.batcher.submit(PlanRequest(
                        uid=uid, seed=uid, cond=self.request_cond(obs[i], returns_label)))
                    uids.append(uid)
                sp["attrs"]["uids"] = list(uids)
                done = self.batcher.run_to_completion()
                for i, uid in enumerate(uids):
                    req = done[uid]
                    a = torch.from_numpy(np.ascontiguousarray(first_action(req.result, self.pcfg)))
                    obs[i], rewards[round_i, i] = self.env.step(obs[i], a, generator)
                    nfes[round_i, i] = req.nfe
        b = self.batcher
        return {
            "rewards": rewards,
            "nfe": nfes,
            "finished": b.finished,
            "total_iterations": b.total_iterations,
            "wasted_nfe_fraction": b.wasted_nfe_fraction,
            "passenger_nfe_fraction": b.passenger_nfe_fraction,
            "refills_per_device": list(b.refills_per_device),
        }
