"""Receding-horizon planner launcher (DESIGN.md §10); port of
``repro/launch/plan.py``.

Runs the planning closed loop on an analytic environment: every control
round each environment submits a plan request (its state pinned by
horizon-axis inpainting, optionally a returns-bin CFG label) into the
continuous-batching ``DiffusionBatcher``, executes the first action of
its delivered plan, and queues the re-conditioned request again.

The score is the analytic returns-binned Gaussian
(``class_gaussian_noise_pred``: exact and train-free) unless ``--unet``
takes a temporal UNet made from seed 0 (its zero-init output gives prior
plans); ``--unet-attention`` adds the bottleneck attention block through
the flash kernel (K3) and ``--fused-norm`` runs every GroupNorm → SiLU
through K6, on the card. ``--compare-em N`` also prints the single-shot
adaptive-against-EM-N NFE on the trajectory shape. Everything runs on
``--device`` (``cuda`` unless the caller passes ``cpu``):

  PYTHONPATH=src python -m repro_torch.launch.plan --device cpu \\
      [--env ou|pointmass] [--envs 6] [--steps 4] [--slots 4] \\
      [--sync-horizon 4] [--horizon 8] [--cfg-scale 1.5] [--unet] \\
      [--unet-attention] [--fused-norm] [--compare-em 200] [--no-compaction]

``launch.serve --plan`` exposes the same loop through the serving CLI.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.analytic import class_gaussian_noise_pred, gaussian_score
from repro_torch.core.precision import PRESETS, resolve_policy
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VPSDE
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.device import resolve_device
from repro_torch.planning import PlannerConfig, RecedingHorizonPlanner, get_env

MU, S0 = 0.3, 0.5
RETURNS_BINS = 5


def _make_forward(pcfg: PlannerConfig, unet: bool, precision: str,
                  attention: bool = False, fused_norm: bool = False, device="cuda"):
    """(sde, forward_fn(params, x, t, y=None), params): the analytic
    returns-binned Gaussian, or a temporal UNet from seed 0 on ``device``
    (``attention`` adds the bottleneck block through the flash kernel,
    ``fused_norm`` the fused GroupNorm → SiLU)."""
    sde = VPSDE()
    policy = resolve_policy(precision)
    if not unet:
        mus = MU + 0.5 * torch.linspace(-1.0, 1.0, RETURNS_BINS)
        f = class_gaussian_noise_pred(sde, mus, S0, MU)
        return sde, (lambda p, x, t, y=None: f(x, t, y)), None
    from repro_torch.models.temporal_unet import (
        TemporalUNetConfig, init_temporal_unet, temporal_unet_forward,
    )

    ucfg = TemporalUNetConfig(
        horizon=pcfg.horizon, transition_dim=pcfg.transition_dim, base=16, mults=(1, 2),
        t_dim=32, groups=4, returns_bins=RETURNS_BINS if pcfg.guidance_scale else 0,
        attention=attention, use_flash=attention, use_fused_norm=fused_norm)
    dev = resolve_device(device)
    # weights stored at the policy's param dtype (reference :72)
    params = policy.cast_params(
        init_temporal_unet(ucfg, torch.Generator(device=dev).manual_seed(0)))

    def fwd(p, x, t, y=None):
        return temporal_unet_forward(p, x, t, policy=policy, y=y)

    return sde, fwd, params


def serve_planning(*, env_name: str = "ou", envs: int = 6, steps: int = 4, slots: int = 4,
                   sync_horizon: int = 4, compaction: bool = True, horizon: int = 8,
                   cfg_scale: float = 0.0, precision: str = "fp32", unet: bool = False,
                   unet_attention: bool = False, fused_norm: bool = False,
                   returns_label: int | None = None, seed: int = 1, device="cuda") -> dict:
    """Closed-loop planning as a service on ``device``: ``envs × steps`` plan
    requests drain through the batcher, each plan's first action executed
    between rounds. Returns (and prints) plans/s, per-plan NFE, reward and
    the waste books. ``returns_label`` is every request's bin (default:
    the top bin under guidance, else none); ``seed`` draws the
    environments' resets and noise."""
    dev = resolve_device(device)
    env = get_env(env_name)
    pcfg = PlannerConfig(horizon=horizon, obs_dim=env.obs_dim, act_dim=env.act_dim,
                         guidance_scale=cfg_scale)
    sde, fwd, params = _make_forward(pcfg, unet, precision, attention=unet_attention,
                                     fused_norm=fused_norm, device=dev)
    rh = RecedingHorizonPlanner(
        sde, fwd, params, pcfg, env, cfg=AdaptiveConfig(eps_rel=0.05, precision=precision,
                                                         use_fused_kernel=True),
        slots=slots, sync_horizon=sync_horizon, compaction=compaction, device=dev)
    if returns_label is None and cfg_scale:
        returns_label = RETURNS_BINS - 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = rh.rollout(seed, n_envs=envs, n_steps=steps, returns_label=returns_label)
    dt = time.perf_counter() - t0
    n_plans = envs * steps
    b = rh.batcher
    rec = {
        "env": env_name, "envs": envs, "steps": steps, "slots": slots,
        "sync_horizon": sync_horizon, "compaction": compaction,
        "score": "temporal_unet" if unet else "analytic", "cfg_scale": cfg_scale,
        "plans": n_plans, "plans_per_sec": n_plans / dt,
        "mean_nfe": float(out["nfe"].mean()),
        "mean_reward": float(out["rewards"].mean()),
        "final_round_reward": float(out["rewards"][-1].mean()),
        "wasted_nfe_fraction": out["wasted_nfe_fraction"],
        "passenger_nfe_fraction": out["passenger_nfe_fraction"],
        "refills_per_device": out["refills_per_device"],
        # the port's own: the device, the wall time, the label, the reads
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "wall_s": dt, "returns_label": returns_label,
        "host_transfers": b.host_transfers, "solver_syncs": b.solver_syncs,
    }
    print(f"plan serve[{env_name}, {rec['score']}, cfg={cfg_scale}] on {rec['device']}: "
          f"{n_plans} plans in {dt:.2f} s ({rec['plans_per_sec']:.2f} plans/s), {envs} envs "
          f"x {steps} rounds on {slots} slots (horizon {sync_horizon}), mean NFE "
          f"{rec['mean_nfe']:.1f}, mean reward {rec['mean_reward']:.3f} (final round "
          f"{rec['final_round_reward']:.3f}), wasted NFE {rec['wasted_nfe_fraction']:.1%}, "
          f"host transfers {b.host_transfers}, solver syncs {b.solver_syncs}")
    return rec


def compare_em(horizon: int = 8, dim: int = 4, batch: int = 64, em_steps: int = 200,
               device="cuda") -> dict:
    """Single-shot adaptive against EM-``em_steps`` NFE on the trajectory
    shape, at the image defaults' tolerance (DESIGN.md §10)."""
    sde = VPSDE()
    score = gaussian_score(sde, MU, S0)
    shape = (batch, horizon, dim)
    res_ad = sample(sde, score, shape, seed=0, method="adaptive", eps_rel=0.05, device=device)
    res_em = sample(sde, score, shape, seed=0, method="em", n_steps=em_steps, device=device)
    rec = {"shape": shape, "adaptive_nfe": float(res_ad.mean_nfe),
           "em_nfe": float(res_em.mean_nfe),
           "nfe_ratio": float(res_ad.mean_nfe) / float(res_em.mean_nfe)}
    print(f"trajectory ({horizon}x{dim}): adaptive NFE {rec['adaptive_nfe']:.0f} vs "
          f"EM-{em_steps} NFE {rec['em_nfe']:.0f} ({rec['nfe_ratio']:.2f}x)")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="ou", choices=["ou", "pointmass"])
    ap.add_argument("--envs", type=int, default=6)
    ap.add_argument("--steps", type=int, default=4, help="control rounds per environment")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--sync-horizon", type=int, default=4)
    ap.add_argument("--no-compaction", action="store_true")
    ap.add_argument("--horizon", type=int, default=8, help="plan horizon H (trajectory rows)")
    ap.add_argument("--cfg-scale", type=float, default=0.0,
                    help="returns-CFG guidance scale (DESIGN.md §10)")
    ap.add_argument("--precision", choices=sorted(PRESETS), default="fp32")
    ap.add_argument("--unet", action="store_true",
                    help="a temporal UNet from seed 0 instead of the analytic score")
    ap.add_argument("--unet-attention", action="store_true",
                    help="with --unet: the bottleneck attention block, through the "
                         "flash kernel (K3)")
    ap.add_argument("--fused-norm", action="store_true",
                    help="with --unet: every GroupNorm → SiLU through the fused kernel (K6)")
    ap.add_argument("--compare-em", type=int, default=None, metavar="N",
                    help="also print adaptive vs EM-N NFE on the trajectory shape")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    rec = serve_planning(
        env_name=args.env, envs=args.envs, steps=args.steps, slots=args.slots,
        sync_horizon=args.sync_horizon, compaction=not args.no_compaction,
        horizon=args.horizon, cfg_scale=args.cfg_scale, precision=args.precision,
        unet=args.unet, unet_attention=args.unet_attention, fused_norm=args.fused_norm,
        device=args.device)
    if args.compare_em is not None:
        rec["compare_em"] = compare_em(horizon=args.horizon, em_steps=args.compare_em,
                                       device=args.device)
    return rec


if __name__ == "__main__":
    main()
