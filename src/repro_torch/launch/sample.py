"""Demo sampling launcher; port of the run and dry-run modes of
``repro/launch/sample.py`` and of its ``make_sample_step``, the serving
loop's device step.

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
``mesh=``, the adaptive solve and then EM, each data-parallel; rank 0
prints the gathered result's record.

  torchrun --nproc-per-node 2 --master-addr localhost --master-port 29500 \
      -m repro_torch.launch.sample --device cpu

``--dryrun`` counts one Algorithm-1 iteration (two forwards and the step
math, as the reference's ``dryrun``) of HIGHRES_DIT on the VE SDE at
batch 512, on meta tensors (no card, nothing drawn), under
``--precision``'s policy, and one forward alone (one NFE): FLOPs and
bytes from ``launch/dryrun.py::count``, and the policy's dtypes with the
weight and state bytes they imply (``_precision_record``, one device).
The record goes to ``--out`` (default ``experiments/dryrun_torch/``).
The whole sharded loop (``--dryrun-loop``) and the two-pod mesh
(``--multi-pod``) wait for the dry run under a mesh (ROADMAP A11 (iii)),
the pipelined forward (``--pipeline``) for ``parallel/pipeline.py``
(A11 (ii)); each says so when asked for.

  PYTHONPATH=src python -m repro_torch.launch.sample --dryrun --precision bf16_full
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
from repro_torch.core.sde import VESDE, VPSDE, bcast
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers.adaptive import AdaptiveConfig, capture_horizon, solve_chunk
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.solver_step import ops as step_ops
from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR, count
from repro_torch.models.dit import (
    DiT, dit_forward, init_dit, liven_zero_init, make_score_fn, param_count,
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
    buffers (``adaptive.capture_horizon``). Under a mesh both take the
    slots' ``sharding`` (the carry is this rank's rows), and the capture
    the driver's ``flags`` (``adaptive.MeshFlags``).

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

    def sample_step(params, carry, max_sync_iters: int = 1, sharding=None):
        return solve_chunk(sde, score_of(params), carry, max_sync_iters=max_sync_iters,
                           config=cfg, sharding=sharding)

    def capture(params, carry, sync_horizon, sharding=None, flags=None):
        return capture_horizon(sde, score_of(params), carry, sync_horizon=sync_horizon,
                               config=cfg, sharding=sharding, flags=flags)

    sample_step.score_of = score_of
    sample_step.capture_horizon = capture
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


def _precision_record(policy, params, state_x) -> dict:
    """The policy's dtypes and the bytes they imply (reference :214) on
    one device: the stored weights, and x and x_prev of the carry
    (``state_x`` is the (B, ...) state)."""
    rec = policy.as_dict()
    rec["param_bytes_total"] = sum(p.numel() * p.element_size() for p in params)
    rec["state_bytes_per_device"] = 2 * state_x.numel() * state_x.element_size()
    return rec


def dryrun(batch: int = 512, precision: str = "fp32", *, arch: str = "highres_dit",
           out_dir: str = DRYRUN_DIR, save: bool = True) -> dict:
    """One Algorithm-1 iteration of ``arch`` on the VE SDE (σ_max 50, the
    paper's high-resolution process, eps_rel 0.02), counted on meta
    tensors under ``precision`` (reference :236); one forward counted
    alone gives the per-NFE FLOPs and bytes. The plain attention and step
    math run (``use_flash=False``, ``use_fused_kernel=False``): the
    kernels' wrappers take CPU or CUDA tensors only."""
    meta = torch.device("meta")
    net = dataclasses.replace(ARCHS[arch], use_flash=False)
    sde = VESDE(sigma_max=50.0)
    policy = resolve_policy(precision)
    model = policy.cast_params(DiT(net, device=meta))  # stored at the param dtype
    shape = (batch, net.image_size, net.image_size, net.channels)
    cfg = AdaptiveConfig(eps_rel=0.02, precision=policy)
    step = make_sample_step(sde, cfg)
    carry = ad.init_carry(sde, torch.empty(shape, device=meta), None, config=cfg)
    body = ad._make_body(sde, step.score_of(model), cfg, float(sde.abs_tolerance),
                         ad._step_math_jnp, noise_fn=torch.randn_like)
    with torch.no_grad():
        it = count(body, carry)
        nfe = count(lambda x, t: dit_forward(model, x, t, policy=policy),
                    carry.x, carry.t)
    rec = {"arch": f"dit-{arch.removesuffix('_dit')}-sampler", "shape": f"sample_b{batch}_"
           f"{net.image_size}px", "mesh": "1card", "devices": 1, "dtype": policy.compute_dtype,
           "cost": it, "per_nfe": {"flops": nfe["flops"],
                                   "bytes": nfe["est_hbm_traffic_bytes"]},
           "precision": _precision_record(policy, model.parameters(), carry.x),
           "note": "one Algorithm-1 iteration (2 score-net forwards + step math)"}
    if save:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if policy.is_fp32 else f"_{policy.name}"
        with open(os.path.join(out_dir, f"{rec['arch']}_{rec['shape']}_1card{suffix}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
    print(f"[{rec['arch']} × {rec['shape']} × 1card, {policy.name}] flops {it['flops']:.3e} "
          f"(a forward {nfe['flops']:.3e}), traffic {it['est_hbm_traffic_bytes'] / 2**30:.2f} "
          f"GiB, weights {rec['precision']['param_bytes_total'] / 2**30:.3f} GiB, state "
          f"{rec['precision']['state_bytes_per_device'] / 2**30:.3f} GiB")
    return rec


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
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    help="cifar_dit; highres_dit with --dryrun")
    ap.add_argument("--batch", type=int, help="8; 512 with --dryrun")
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
    ap.add_argument("--dryrun", action="store_true",
                    help="count one iteration at --batch (default 512) on meta tensors")
    ap.add_argument("--out", default=DRYRUN_DIR, help="the dry run's record directory")
    waits = {"dryrun_loop": "the dry run under a mesh, ROADMAP A11 (iii)",
             "pipeline": "parallel/pipeline.py, ROADMAP A11 (ii)",
             "multi_pod": "the dry run under a mesh, ROADMAP A11 (iii)"}
    for flag, what in waits.items():
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help=f"waits for {what}")
    args = ap.parse_args(argv)
    for flag, what in waits.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} waits for {what}")
    if args.dryrun:
        return [dryrun(args.batch or 512, args.precision, arch=args.arch or "highres_dit",
                       out_dir=args.out)]
    args.arch, args.batch = args.arch or "cifar_dit", args.batch or 8
    mesh, device = None, args.device
    methods = (("adaptive", {}), ("em", dict(n_steps=100)))
    if "WORLD_SIZE" in os.environ:
        mesh = torchrun_mesh(args.device)
        device = mesh.device
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


def torchrun_mesh(device: str):
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
