"""Demo sampling launcher; port of the run mode of
``repro/launch/sample.py`` and of its ``make_sample_step``, the serving
loop's device step (its dry-run modes lower XLA programs and have no
counterpart here).

Samples a batch from a DiT score network made from a seed on the VP SDE,
first with the adaptive solver and then with Euler–Maruyama at 100
steps, as the reference's demo does, and prints for each the NFE,
iterations, the converged count, wall time and the kernels' launch
counts:

  PYTHONPATH=src python -m repro_torch.launch.sample --arch highres_dit --fused --flash

A fresh DiT returns exactly 0 (its adaLN and output projections start at
zero), so ``--liven-seed`` gives those leaves random values first; the
launcher's default livens with seed 0, and ``--liven-seed -1`` keeps the
reference demo's zero-output network.

Under ``torchrun`` (``WORLD_SIZE`` set) the launcher is data-parallel:
each rank initialises the process group from torchrun's environment
(NCCL on ``cuda``, each rank on card ``LOCAL_RANK``; gloo on ``cpu``),
builds a ``("data", "model")`` mesh of WORLD_SIZE × 1 and samples with
``mesh=``; rank 0 prints the gathered result's record. Only the adaptive
solve runs there: the baselines are not data-parallel yet (ROADMAP A11).

  torchrun --nproc-per-node 2 --master-addr localhost --master-port 29500 \
      -m repro_torch.launch.sample --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import inspect
import json
import os
import time

import torch

from repro_torch.configs.diffusion import ARCHS
from repro_torch.core.precision import PRESETS, resolve_policy
from repro_torch.core.sampling import gather_result, sample
from repro_torch.core.sde import VPSDE, bcast
from repro_torch.core.solvers.adaptive import AdaptiveConfig, capture_horizon, solve_chunk
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.solver_step import ops as step_ops
from repro_torch.models.dit import (
    dit_forward, init_dit, liven_zero_init, make_score_fn, param_count,
)


#: the solvers that run Algorithm 1's body and take its configuration
ADAPTIVE_FAMILY = ("adaptive", "momentum", "heun")


def build_score(arch: str, *, flash: bool, precision: str, seed: int,
                liven_seed: int, device) -> tuple:
    """(cfg, model, score_fn) for ``arch`` on ``device``: weights drawn
    from ``seed``; the zero-init leaves livened from ``liven_seed`` unless
    it is negative."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(ARCHS[arch], use_flash=flash)
    model = init_dit(cfg, torch.Generator(device=dev).manual_seed(seed))
    if liven_seed >= 0:
        liven_zero_init(model, torch.Generator(device=dev).manual_seed(liven_seed))
    policy = resolve_policy(precision)
    return cfg, model, make_score_fn(model, VPSDE(), policy=policy)


def make_sample_step(sde, cfg: AdaptiveConfig, forward_fn=None):
    """Resumable Algorithm-1 chunk as a step function; port of the
    reference's ``make_sample_step`` (``repro/launch/sample.py:104``).

    Returns ``step(params, carry, max_sync_iters=1) -> carry`` over the
    port's ``solve_chunk``, so serving runs the very body ``adaptive()``
    runs (fused kernel, per-slot noise streams, NFE accounting, the
    telemetry ring) and chained chunks give the monolithic solve's bits.
    This is the unit the serving loop repeats between its syncs.
    ``step.capture_horizon(params, carry, sync_horizon)`` hands the
    device-resident driver the same unit as a CUDA graph over ``carry``'s
    buffers (``adaptive.capture_horizon``).

    ``forward_fn(params, x, t[, y])`` predicts noise: score = −out/std,
    with the division in fp32. The default is the DiT forward,
    ``params`` the ``DiT`` module, run at ``cfg.precision``'s compute
    dtype. ``cfg.conditioner`` threads through ``solve_chunk`` (DESIGN.md
    §9): with a ``ClassifierFree`` conditioner the score must take labels,
    so it passes ``y`` whenever ``forward_fn`` declares it (the default
    forward does). The reference's first argument, the DiT config, is not
    taken: the port's ``DiT`` module carries its own.
    """
    policy = resolve_policy(cfg.precision)
    if forward_fn is None:
        forward_fn = lambda model, x, t, y=None: dit_forward(model, x, t, policy=policy, y=y)
    accepts_y = "y" in inspect.signature(forward_fn).parameters

    def score_of(params):
        def score_fn(x, t, y=None):
            _, std = sde.marginal(t)
            out = (forward_fn(params, x, t, y=y) if accepts_y
                   else forward_fn(params, x, t)).to(torch.float32)
            return -out / bcast(std, x)

        return score_fn

    def sample_step(params, carry, max_sync_iters: int = 1):
        return solve_chunk(sde, score_of(params), carry, max_sync_iters=max_sync_iters,
                           config=cfg)

    sample_step.capture_horizon = lambda params, carry, sync_horizon: capture_horizon(
        sde, score_of(params), carry, sync_horizon=sync_horizon, config=cfg)
    return sample_step


def run(arch: str = "cifar_dit", *, batch: int = 8, precision: str = "fp32",
        eps_rel: float = 0.05, max_iters: int = 100_000, flash: bool = False,
        fused: bool = False, seed: int = 0, liven_seed: int = 0,
        device="cuda", method: str = "adaptive", mesh=None,
        **solver_kwargs) -> dict:
    """One sample with ``method``; returns the record the launcher prints.

    ``eps_rel``, ``max_iters``, ``fused`` and ``precision`` configure the
    Algorithm-1 families (``ADAPTIVE_FAMILY``: ``adaptive``, ``momentum``,
    ``heun``); ``solver_kwargs`` go to the solver as they are (for
    example ``n_steps`` for the fixed-grid baselines). With ``mesh`` the
    solve is data-parallel (a collective: every rank calls ``run``); the
    wall time is this rank's, and the record describes the whole batch,
    gathered from every rank after the timed solve.
    """
    dev = resolve_device(device)
    cfg, model, score = build_score(arch, flash=flash, precision=precision,
                                    seed=seed, liven_seed=liven_seed, device=dev)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.channels)
    if method in ADAPTIVE_FAMILY:
        solver_kwargs = dict(eps_rel=eps_rel, max_iters=max_iters,
                             use_fused_kernel=fused, precision=precision,
                             **solver_kwargs)
    before = (step_ops.launches, step_ops.em_launches, flash_ops.launches,
              step_ops.sharded_launches)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = sample(VPSDE(), score, shape, seed=seed, device=dev, method=method,
                 mesh=mesh, **solver_kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {"solver_step": step_ops.launches - before[0],
                "em_step": step_ops.em_launches - before[1],
                "flash_attention": flash_ops.launches - before[2],
                "sharded_solver_step": step_ops.sharded_launches - before[3]}
    if mesh is not None:
        res = gather_result(res, mesh, batch)
    return {
        "arch": arch, "method": method, "params": param_count(model),
        "batch": batch, "precision": precision,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "mean_nfe": float(res.mean_nfe), "max_nfe": int(res.max_nfe),
        "iterations": int(res.iterations),
        "converged": _converged(res, max_iters) if method in ADAPTIVE_FAMILY else batch,
        "wall_s": wall,
        "finite": bool(torch.isfinite(res.x).all()),
        "shape": list(res.x.shape),
        "launches": launches,
        "ranks": 1 if mesh is None else mesh.size,
        "result": res,
    }


def _converged(res, max_iters: int) -> int:
    """Samples that reached t_eps. Below the iteration cap the solve ran
    until all did; at the cap, a sample that was active in every
    iteration (nfe = 2·iterations + 1 with the denoise evaluation) is
    counted as not converged."""
    if int(res.iterations) < max_iters:
        return int(res.x.shape[0])
    return int((res.nfe < 2 * int(res.iterations) + 1).sum())


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="cifar_dit")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--precision", choices=sorted(PRESETS), default="fp32")
    ap.add_argument("--eps-rel", type=float, default=0.05)
    ap.add_argument("--max-iters", type=int, default=100_000)
    ap.add_argument("--flash", action="store_true",
                    help="DiT attention through the flash kernel")
    ap.add_argument("--fused", action="store_true",
                    help="solver step through the fused kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--liven-seed", type=int, default=0,
                    help="seed for the zero-init leaves; -1 keeps them at 0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh, device = None, args.device
    methods = (("adaptive", {}), ("em", dict(n_steps=100)))
    if "WORLD_SIZE" in os.environ:
        mesh = _torchrun_mesh(args.device)
        device, methods = mesh.device, methods[:1]
    recs = []
    for method, kw in methods:
        rec = run(args.arch, batch=args.batch, precision=args.precision,
                  eps_rel=args.eps_rel, max_iters=args.max_iters, flash=args.flash,
                  fused=args.fused, seed=args.seed, liven_seed=args.liven_seed,
                  device=device, method=method, mesh=mesh, **kw)
        if mesh is None or mesh.coordinate == (0, 0):
            print(json.dumps({k: v for k, v in rec.items() if k != "result"}))
        recs.append(rec)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return recs


def _torchrun_mesh(device: str):
    """The WORLD_SIZE × 1 mesh of a torchrun job: NCCL with one card per
    rank on ``cuda``, gloo on ``cpu``; torchrun's environment gives the
    rendezvous address."""
    from repro_torch.parallel import init_mesh

    world, local = int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", local))
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
        timeout=datetime.timedelta(seconds=60))
    return init_mesh(world, 1, device=dev)


if __name__ == "__main__":
    main()
