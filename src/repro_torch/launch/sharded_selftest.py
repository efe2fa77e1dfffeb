"""Self-test of the port's mesh-sharded sampling path; port of
``repro/launch/sharded_selftest.py`` (DESIGN.md §3).

Spawns ``--world`` ranks with ``torch.multiprocessing.spawn``, each in a
``torch.distributed`` process group (``--backend`` gloo or nccl, on
``--device`` cpu or cuda; every rank on ``cuda:rank % cards``), and runs
the multi-rank path end to end:

  1. ``sample(..., mesh=)`` on the closed-form Gaussian score (VP,
     batch 2·world × 64) is bit-identical to the unsharded run, with the
     plain step math and with the fused kernel (K4 on each rank), and
     ``gather_result`` reassembles the unsharded batch;
  2. K4, ``sharded_error_step``, against K1 (``error_step``) on the whole
     state, at the reference selftest's (8, 10, 10, 3) and at the
     HIGHRES_DIT state (8, 196,608), fp32 and bf16: batch-sharded over a
     ``("data",)`` mesh of all ranks, x'' and e2 bitwise; batch- and
     feature-sharded over a (world/2, 2) ``("data", "model")`` mesh (1 × 1
     at world 1), x'' bitwise and e2 within ``FEATURE_RTOL``;
  3. ``batcher``, the reference's check 3 at its size: a
     ``DiffusionBatcher(mesh=)`` on the Gaussian noise prediction (VP,
     eps_rel 0.05, ``sample_shape`` (32,), 2·world slots, 6·world
     requests, sync horizon 4) delivers every request, finite, each
     bitwise the same request from an unsharded batcher at sync horizon
     1; every device refills past its first fill, and the refills sum to
     the requests;
  4. ``device_resident``, the reference's check 4: the same server
     device-resident, bitwise the host-driven mesh server per request,
     with equal iterations and fewer host reads. Where the mesh cannot
     be captured (gloo on the card) it checks instead that asking for it
     raises;
  5. with ``--arch``, one solve of that DiT (weights from seed 0, livened
     from seed 0, VP, batch 8, eps_rel 0.05, fp32, fused step and flash
     attention) through ``repro_torch.launch.sample.run(mesh=)``, against
     the unsharded ``run`` on rank 0: bitwise at world 1; at a larger
     world, where the rows of a dense product may round otherwise at
     another M, every sample finite and converged and its NFE within
     ``NFE_SLACK`` of the unsharded run's (bitwise is reported). K4 and
     flash launches are counted from 0 over the sharded solve. Then the
     warm wall times in turns: that sharded solve, the unsharded one
     twice on rank 0, the sharded one again (the first, unsharded solve
     is the cold call). Then EM at ``EM_STEPS`` steps from that DiT under
     ``mesh=`` (K5), against the unsharded run: bitwise at world 1;
  6. with ``--arch``, the tiered serve of that DiT (``serve_arch``:
     ``SERVE_SLOTS`` slots, ``SERVE_REQUESTS`` requests over the three
     tiers under EDF, sync horizon 4; K4 with per-row tolerances, K3,
     P1) under the mesh, host-driven and, where the mesh can be captured,
     device-resident (P2 and the NCCL all-reduce in the WHILE node's
     body), against the unsharded serve on rank 0: per request bitwise at
     world 1; at a larger world every request delivered finite with its
     NFE within ``NFE_SLACK`` (bitwise is reported) and the devices'
     refills summing to the requests. (Per-device refill is check 3's
     gate: under EDF the five high-fidelity requests are seated first,
     four of them in block 0, which then holds them until the queue has
     drained through the other blocks, so block 0 need not refill.) The
     kernels' launches are counted from 0 over each mesh serve.

On the card one ``all_reduce`` of 9 floats is timed.

Prints one JSON line with the results; exits non-zero on any failure.

  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cpu --world 4
  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cuda --backend nccl --world 1 --arch highres_dit
  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cuda --backend gloo --world 2 --arch highres_dit
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import pickle
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: e2 of the feature-split K4 against K1 on the whole state: the same
#: terms summed in another grouping (per range, then across ranges)
FEATURE_RTOL = 1e-6
#: per-sample NFE of a multi-rank DiT solve against the unsharded one
NFE_SLACK = 4
#: kernel-check states: the reference selftest's and HIGHRES_DIT's
KERNEL_SHAPES = ((8, 10, 10, 3), (8, 256 * 256 * 3))
#: seconds a rank waits for the others before a collective fails
PG_TIMEOUT_S = 60
#: EM steps of check 5 (phase 3's EM-59 of chip_smoke.py)
EM_STEPS = 59
#: the tiered serve of check 6: chip_smoke.py phase 6a's
SERVE_SLOTS, SERVE_REQUESTS, SERVE_HORIZON = 8, 16, 4
SERVE_TIERS = ("draft", "standard", "high_fidelity")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world: int, *args) -> list:
    """Run ``fn(rank, world, port, out_dir, *args)`` on ``world`` spawned
    ranks and return what each pickled to ``out_dir/rank{r}.pkl`` (a file
    each: results through a pipe would block a rank until the parent
    reads, and the parent reads after every rank has ended). Raises if a
    rank raises."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(fn, args=(world, free_port(), out_dir, *args), nprocs=world)
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    return ranks


def put_result(out_dir: str, rank: int, result) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def init_rank(rank: int, world: int, port: int, device: str, backend: str):
    """Join the process group; returns this rank's torch.device."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return dev


def check_sample_equivalence(mesh, dev, *, fused: bool) -> dict:
    """sample() sharded vs unsharded: same seed ⇒ bit-identical rows."""
    from repro_torch.core import analytic
    from repro_torch.core.sampling import gather_result, sample
    from repro_torch.core.sde import VPSDE
    from repro_torch.parallel import sample_state_shardings

    sde = VPSDE()
    score = analytic.gaussian_score(sde)
    shape = (2 * mesh.size, 64)
    kw = dict(seed=0, device=dev, eps_rel=0.05, use_fused_kernel=fused)
    ref = sample(sde, score, shape, **kw)
    sh = sample(sde, score, shape, mesh=mesh, **kw)
    arr, _, _ = sample_state_shardings(mesh, shape[0], len(shape))
    rows = arr.rows
    full = gather_result(sh, mesh, shape[0])
    same = lambda a, b: bool(torch.equal(a, b))
    return {
        "bitwise_equal": same(sh.x, ref.x[rows]) and same(sh.nfe, ref.nfe[rows])
        and same(sh.accepted, ref.accepted[rows]) and same(sh.rejected, ref.rejected[rows]),
        "iterations_equal": int(sh.iterations) == int(ref.iterations),
        "gathered_equal": same(full.x, ref.x) and same(full.nfe, ref.nfe),
        "max_abs_diff": float((sh.x - ref.x[rows]).abs().max()),
        "mean_nfe": float(ref.mean_nfe),
        "n_shards": arr.n_shards,
        "sharded_over_ranks": arr.n_shards == mesh.size,
    }


def check_fused_kernel(mesh1d, mesh2d, dev) -> dict:
    """sharded_error_step vs error_step on the whole state."""
    from repro_torch.kernels.solver_step import ops
    from repro_torch.parallel import batch_sharding

    out = {"batch_sharded_bitwise": True, "feature_sharded_close": True,
           "max_rel_e2_feature": 0.0, "cases": 0}
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            B = shape[0]
            states = [torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for _ in range(5)]
            coeffs = [0.01 * torch.randn(B, generator=gen, device=dev) for _ in range(3)]
            kw = dict(eps_abs=1e-2, eps_rel=0.01)
            ref_x, ref_e = ops.error_step(*states, *coeffs, **kw)
            # batch-sharded over every rank
            rows = batch_sharding(mesh1d, B, len(shape)).rows
            b_x, b_e = ops.sharded_error_step(
                *(a[rows] for a in states), *(c[rows] for c in coeffs),
                mesh=mesh1d, batch_axes=("data",), **kw)
            out["batch_sharded_bitwise"] &= bool(
                torch.equal(b_x, ref_x[rows]) and torch.equal(b_e, ref_e[rows]))
            # batch- and feature-sharded
            rows = batch_sharding(mesh2d, B, len(shape)).rows
            f_x, f_e = ops.sharded_error_step(
                *(a[rows] for a in states), *(c[rows] for c in coeffs),
                mesh=mesh2d, batch_axes=("data",), feature_axis="model", **kw)
            D = ref_x[0].numel()
            start, stop = ops.feature_range(D, mesh2d.shape["model"], mesh2d.coord("model"))
            want_x = ref_x[rows].reshape(f_x.shape[0], D)[:, start:stop]
            rel = float(((f_e - ref_e[rows]).abs() / ref_e[rows].abs()).max())
            out["feature_sharded_close"] &= bool(torch.equal(f_x, want_x)) and rel <= FEATURE_RTOL
            out["max_rel_e2_feature"] = max(out["max_rel_e2_feature"], rel)
            out["cases"] += 1
    return out


def gaussian_batcher(dev, *, slots: int, sync_horizon: int, mesh=None, **kw):
    """The reference selftest's server: VP, eps_rel 0.05, the Gaussian
    noise prediction as the net, ``sample_shape`` (32,)."""
    from repro_torch.core import analytic
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.serving.diffusion_server import DiffusionBatcher

    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05)
    fwd = analytic.gaussian_noise_pred(sde)
    step = make_sample_step(sde, cfg, forward_fn=lambda p, x, t: fwd(x, t))
    return DiffusionBatcher(sde, step, None, (32,), slots=slots, cfg=cfg, mesh=mesh,
                            sync_horizon=sync_horizon, device=dev, **kw)


def drain(b, n_req: int) -> dict:
    """Submit requests 0..n_req-1 (seed = uid) and run to completion."""
    from repro_torch.serving.diffusion_server import ImageRequest

    for uid in range(n_req):
        b.submit(ImageRequest(uid=uid, seed=uid))
    return b.run_to_completion()


def same_requests(got: dict, want: dict, n_req: int) -> bool:
    """Every request delivered by both, each bitwise equal."""
    return (len(got) == len(want) == n_req
            and all(np.array_equal(got[u].result, want[u].result) and got[u].nfe == want[u].nfe
                    for u in range(n_req)))


def check_batcher(mesh, dev) -> dict:
    """Check 3: the sharded DiffusionBatcher, completion and per-device
    refill, against an unsharded batcher at another sync horizon."""
    slots, n_req = 2 * mesh.size, 6 * mesh.size
    b = gaussian_batcher(dev, slots=slots, sync_horizon=4, mesh=mesh)
    done = drain(b, n_req)
    xs = np.stack([done[u].result for u in sorted(done)])
    b_ref = gaussian_batcher(dev, slots=slots, sync_horizon=1)
    done_ref = drain(b_ref, n_req)
    return {
        "all_completed": len(done) == n_req,
        "finite": bool(np.isfinite(xs).all()),
        "slots_per_device": b.slots_per_device,
        "refills_per_device": list(b.refills_per_device),
        "per_device_refill": all(r > b.slots_per_device for r in b.refills_per_device),
        "total_assignments_match": sum(b.refills_per_device) == n_req,
        "wasted_nfe_fraction": b.wasted_nfe_fraction,
        "scheduling_invariant": same_requests(done, done_ref, n_req),
    }


def capturable(mesh, dev) -> bool:
    """Whether a device-resident mesh server can run here: the CPU's plain
    driver takes any mesh, the card's captured one NCCL's only."""
    from repro_torch.core.solvers.adaptive import mesh_capturable

    return dev.type == "cpu" or mesh_capturable(mesh.group())


def check_device_resident(mesh, dev) -> dict:
    """Check 4: the device-resident mesh server against the host-driven
    one, bitwise, equal iterations, fewer reads; where the mesh cannot be
    captured, that asking for it raises."""
    slots, n_req = 2 * mesh.size, 6 * mesh.size
    if not capturable(mesh, dev):
        try:
            gaussian_batcher(dev, slots=slots, sync_horizon=4, mesh=mesh, device_resident=True)
            raised = False
        except ValueError:
            raised = True
        return {"capturable": False, "raises": raised}
    host = gaussian_batcher(dev, slots=slots, sync_horizon=4, mesh=mesh)
    done_host = drain(host, n_req)
    res = gaussian_batcher(dev, slots=slots, sync_horizon=4, mesh=mesh, device_resident=True)
    done_res = drain(res, n_req)
    return {
        "capturable": True,
        "all_completed": len(done_host) == len(done_res) == n_req,
        "bitwise_equal": same_requests(done_res, done_host, n_req),
        "iterations_equal": host.total_iterations == res.total_iterations,
        "host_transfers": host.host_transfers,
        "resident_transfers": res.host_transfers,
        "transfers_reduced": res.host_transfers < host.host_transfers,
        "graph_captures": res.graph_captures,
    }


def check_arch(mesh, dev, arch: str) -> dict:
    """One DiT solve through the launcher, sharded against unsharded."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.launch import sample as launcher

    kw = dict(batch=8, precision="fp32", eps_rel=0.05, max_iters=400, flash=True,
              fused=True, seed=0, liven_seed=0, device=dev)
    rank0 = dist.get_rank() == 0
    ref = launcher.run(arch, **kw) if rank0 else None
    dist.barrier()
    step_ops.sharded_launches = 0
    step_ops.launches = 0
    flash_ops.launches = 0
    rec = launcher.run(arch, mesh=mesh, **kw)
    launches = {"sharded_solver_step": step_ops.sharded_launches,
                "solver_step": step_ops.launches, "flash_attention": flash_ops.launches}
    # warm wall times in turns: sharded (above), unsharded, unsharded,
    # sharded, so that neither side always runs first
    warm = []
    for _ in range(2):
        u = launcher.run(arch, **kw) if rank0 else None
        dist.barrier()
        warm.append(u["wall_s"] if rank0 else None)
    again = launcher.run(arch, mesh=mesh, **kw)
    # EM under the mesh (K5 on the rank's rows)
    em_kw = dict(batch=8, precision="fp32", flash=True, seed=0, liven_seed=0, device=dev,
                 method="em", n_steps=EM_STEPS)
    em_ref = launcher.run(arch, **em_kw) if rank0 else None
    dist.barrier()
    step_ops.em_launches = 0
    em = launcher.run(arch, mesh=mesh, **em_kw)
    em_launches = step_ops.em_launches
    out = {"arch": arch, "launches": launches, "sharded_wall_s": rec["wall_s"],
           "sharded_walls_s": [rec["wall_s"], again["wall_s"]],
           "iterations": rec["iterations"], "mean_nfe": rec["mean_nfe"]}
    if rank0:
        got, want = rec["result"], ref["result"]
        nfe_diff = int((got.nfe - want.nfe).abs().max())
        out.update(
            unsharded_wall_s=ref["wall_s"], unsharded_warm_walls_s=warm,
            unsharded_iterations=ref["iterations"],
            unsharded_mean_nfe=ref["mean_nfe"],
            bitwise_equal=bool(torch.equal(got.x, want.x) and torch.equal(got.nfe, want.nfe)
                               and rec["iterations"] == ref["iterations"]),
            max_nfe_diff=nfe_diff,
            finite=rec["finite"], converged=rec["converged"],
            max_abs_diff=float((got.x - want.x).abs().max()))
        em_bitwise = bool(torch.equal(em["result"].x, em_ref["result"].x))
        out["em"] = {"steps": EM_STEPS, "launches": em_launches, "bitwise_equal": em_bitwise,
                     "finite": em["finite"], "wall_s": em["wall_s"],
                     "unsharded_wall_s": em_ref["wall_s"],
                     "max_abs_diff": float((em["result"].x - em_ref["result"].x).abs().max())}
        if mesh.size == 1:
            out["ok"] = out["bitwise_equal"] and em_bitwise
        else:
            out["ok"] = (rec["finite"] and rec["converged"] == kw["batch"]
                         and nfe_diff <= NFE_SLACK and em["finite"])
    else:
        out["em"] = {"launches": em_launches}
    return out


def serve_arch(arch: str, dev, *, mesh=None, device_resident: bool = False) -> dict:
    """Check 6's tiered serve of ``arch`` (weights from seed 0, livened from
    seed 0, VP, eps_rel 0.05, fp32, fused step, flash attention), with the
    kernels' launches counted from 0 over the drain; returns the server,
    what it delivered, its wall time and the launches."""
    from repro_torch.configs.diffusion import ARCHS
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.graph_loop import ops as loop_ops
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.models.dit import init_dit, liven_zero_init
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest
    from repro_torch.serving.scheduler import EdfPriorityAdmission

    net = dataclasses.replace(ARCHS[arch], use_flash=True)
    model = init_dit(net, torch.Generator(device=dev).manual_seed(0))
    liven_zero_init(model, torch.Generator(device=dev).manual_seed(0))
    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True)
    b = DiffusionBatcher(sde, make_sample_step(sde, cfg), model,
                         (net.image_size, net.image_size, net.channels),
                         slots=SERVE_SLOTS, cfg=cfg, mesh=mesh, sync_horizon=SERVE_HORIZON,
                         device_resident=device_resident, tolerance_classes=True,
                         admission=EdfPriorityAdmission(aging_s=5.0), device=dev)
    for u in range(SERVE_REQUESTS):
        b.submit(ImageRequest(uid=u, seed=u, tier=SERVE_TIERS[u % 3]))
    for m, name in ((step_ops, "launches"), (step_ops, "sharded_launches"),
                    (flash_ops, "launches"), (ph, "launches"), (loop_ops, "launches")):
        setattr(m, name, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = b.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {"solver_step": step_ops.launches,
                "sharded_solver_step": step_ops.sharded_launches,
                "flash_attention": flash_ops.launches, "philox_normal": ph.launches,
                "horizon_cond": loop_ops.launches}
    del model
    return {"server": b, "done": done, "wall_s": wall, "launches": launches}


def check_arch_serve(mesh, dev, arch: str) -> dict:
    """Check 6: the tiered serve of ``arch`` under the mesh against the
    unsharded serve on rank 0."""
    rank0 = dist.get_rank() == 0
    runs = {"host": serve_arch(arch, dev, mesh=mesh)}
    if capturable(mesh, dev):
        runs["device_resident"] = serve_arch(arch, dev, mesh=mesh, device_resident=True)
    ref = serve_arch(arch, dev) if rank0 else None
    dist.barrier()
    out = {}
    for name, r in runs.items():
        b, done = r["server"], r["done"]
        rec = {"wall_s": r["wall_s"], "launches": r["launches"],
               "delivered": len(done), "host_transfers": b.host_transfers,
               "solver_syncs": b.solver_syncs, "windows": b.horizon_windows,
               "iterations": b.total_iterations, "graph_captures": b.graph_captures,
               "build_s": b._driver.build_s if b._driver is not None else 0.0,
               "refills_per_device": list(b.refills_per_device),
               "slots_per_device": b.slots_per_device,
               "finite": all(np.isfinite(done[u].result).all() for u in done)}
        if rank0:
            want = ref["done"]
            rec["bitwise_equal"] = same_requests(done, want, SERVE_REQUESTS)
            rec["max_nfe_diff"] = max(abs(done[u].nfe - want[u].nfe) for u in want
                                      if u in done) if done else None
            rec["max_abs_diff"] = max(float(np.abs(done[u].result - want[u].result).max())
                                      for u in want if u in done) if done else None
            if mesh.size == 1:
                rec["ok"] = rec["bitwise_equal"]
            else:
                rec["ok"] = (rec["delivered"] == SERVE_REQUESTS and rec["finite"]
                             and rec["max_nfe_diff"] <= NFE_SLACK
                             and sum(b.refills_per_device) == SERVE_REQUESTS)
        out[name] = rec
    if rank0:
        rb = ref["server"]
        out["unsharded"] = {"wall_s": ref["wall_s"], "launches": ref["launches"],
                            "host_transfers": rb.host_transfers,
                            "iterations": rb.total_iterations,
                            "mean_nfe": {t: v["mean_nfe"] for t, v in rb.class_stats.items()}}
        out["ok"] = all(out[n]["ok"] for n in runs)
    if not capturable(mesh, dev):
        out["device_resident"] = {"capturable": False}
    return out


def time_all_reduce(dev, reps: int = 200) -> dict:
    """One all_reduce of 9 fp32 values over the whole world: the mean of
    ``reps`` calls between two CUDA events (device time and the launch
    gaps), and the host wall per call with a synchronise after each."""
    buf = torch.ones(9, device=dev)
    for _ in range(10):
        dist.all_reduce(buf)
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dist.all_reduce(buf)
    end.record()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf)
        torch.cuda.synchronize(dev)
    return {"event_us": start.elapsed_time(end) / reps * 1e3,
            "sync_wall_us": (time.perf_counter() - t0) / reps * 1e6}


def _rank_main(rank: int, world: int, port: int, out_dir: str, opts: dict) -> None:
    from repro_torch.parallel import init_mesh

    dev = init_rank(rank, world, port, opts["device"], opts["backend"])
    try:
        mesh1d = init_mesh(world, 1, device=dev)
        mesh2d = init_mesh(world // 2, 2, device=dev) if world > 1 else mesh1d
        res = {"rank": rank,
               "sample_jnp": check_sample_equivalence(mesh1d, dev, fused=False),
               "sample_fused": check_sample_equivalence(mesh1d, dev, fused=True),
               "fused_kernel": check_fused_kernel(mesh1d, mesh2d, dev),
               "batcher": check_batcher(mesh1d, dev),
               "device_resident": check_device_resident(mesh1d, dev)}
        if opts["arch"]:
            res["arch"] = check_arch(mesh1d, dev, opts["arch"])
            res["arch_serve"] = check_arch_serve(mesh1d, dev, opts["arch"])
        if dev.type == "cuda":
            res["all_reduce_9"] = time_all_reduce(dev)
        put_result(out_dir, rank, res)
    finally:
        dist.destroy_process_group()


def default_backend(device: str, world: int) -> str:
    """NCCL on cuda at world 1; gloo otherwise (NCCL refuses two ranks on
    one card, and runs on cuda only)."""
    return "nccl" if device == "cuda" and world == 1 else "gloo"


def run(world: int, *, device: str = "cuda", backend: str | None = None,
        arch: str | None = None) -> dict:
    """Spawn ``world`` ranks, run the checks, and return the combined
    results with ``ok``; raises if a rank fails. Runs on the card unless
    ``device="cpu"``; ``backend`` defaults to ``default_backend``."""
    backend = backend or default_backend(device, world)
    if world < 1 or (world > 1 and world % 2):
        raise ValueError(f"world {world}: want 1 or an even number of ranks")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu")
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"NCCL needs a card per rank ({world} ranks, "
                             f"{torch.cuda.device_count()} cards); use --backend gloo")
    elif backend == "nccl":
        raise ValueError("NCCL runs on cuda only")
    opts = dict(device=device, backend=backend, arch=arch)
    t0 = time.perf_counter()
    ranks = spawn_ranks(_rank_main, world, opts)
    agree = lambda check, key: all(r[check][key] for r in ranks)
    results = {
        "world": world, "device": device, "backend": backend,
        "seconds": time.perf_counter() - t0,
        "sample_jnp": ranks[0]["sample_jnp"], "sample_fused": ranks[0]["sample_fused"],
        "fused_kernel": {k: v for k, v in ranks[0]["fused_kernel"].items()},
    }
    results["fused_kernel"]["max_rel_e2_feature"] = max(
        r["fused_kernel"]["max_rel_e2_feature"] for r in ranks)
    ok = all(agree(c, k) for c in ("sample_jnp", "sample_fused")
             for k in ("bitwise_equal", "iterations_equal", "gathered_equal",
                       "sharded_over_ranks"))
    ok &= agree("fused_kernel", "batch_sharded_bitwise")
    ok &= agree("fused_kernel", "feature_sharded_close")
    results["batcher"] = ranks[0]["batcher"]
    ok &= all(agree("batcher", k) for k in ("all_completed", "finite", "per_device_refill",
                                             "total_assignments_match",
                                             "scheduling_invariant"))
    results["device_resident"] = ranks[0]["device_resident"]
    if results["device_resident"]["capturable"]:
        ok &= all(agree("device_resident", k) for k in ("all_completed", "bitwise_equal",
                                                         "iterations_equal",
                                                         "transfers_reduced"))
    else:
        ok &= agree("device_resident", "raises")
    if arch:
        results["arch"] = ranks[0]["arch"]
        results["arch"]["launches_per_rank"] = [r["arch"]["launches"] for r in ranks]
        ok &= bool(results["arch"]["ok"])
        results["arch_serve"] = ranks[0]["arch_serve"]
        results["arch_serve"]["launches_per_rank"] = {
            name: [r["arch_serve"][name]["launches"] for r in ranks]
            for name in ("host", "device_resident") if "launches" in ranks[0]["arch_serve"][name]}
        ok &= bool(results["arch_serve"]["ok"])
        if device == "cuda":  # the kernels ran on every rank
            ok &= all(r["arch"]["launches"]["sharded_solver_step"] > 0
                      and r["arch"]["launches"]["flash_attention"] > 0
                      and r["arch"]["em"]["launches"] == EM_STEPS for r in ranks)
            for r in ranks:
                serve = r["arch_serve"]
                for name in ("host", "device_resident"):
                    n = serve[name].get("launches")
                    if n is None:
                        continue
                    ok &= (n["sharded_solver_step"] > 0 and n["flash_attention"] > 0
                           and n["philox_normal"] > 0
                           and (n["horizon_cond"] > 0) == (name == "device_resident"))
    if "all_reduce_9" in ranks[0]:
        results["all_reduce_9"] = ranks[0]["all_reduce_9"]
    results["ok"] = bool(ok)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda at world 1, gloo otherwise")
    ap.add_argument("--arch", default=None,
                    help="also solve with this DiT (e.g. highres_dit) sharded and unsharded")
    args = ap.parse_args(argv)
    backend = args.backend or default_backend(args.device, args.world)
    try:
        results = run(args.world, device=args.device, backend=backend, arch=args.arch)
    except Exception as e:  # a rank raised: report it on the JSON line, exit 1
        print(json.dumps({"world": args.world, "device": args.device, "backend": backend,
                          "error": f"{type(e).__name__}: {e}", "ok": False}))
        return 1
    print(json.dumps(results))
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
