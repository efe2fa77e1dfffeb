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
  3. with ``--arch``, one solve of that DiT (weights from seed 0, livened
     from seed 0, VP, batch 8, eps_rel 0.05, fp32, fused step and flash
     attention) through ``repro_torch.launch.sample.run(mesh=)``, against
     the unsharded ``run`` on rank 0: bitwise at world 1; at a larger
     world, where the rows of a dense product may round otherwise at
     another M, every sample finite and converged and its NFE within
     ``NFE_SLACK`` of the unsharded run's (bitwise is reported). K4 and
     flash launches are counted from 0 over the sharded solve. Then the
     warm wall times in turns: that sharded solve, the unsharded one
     twice on rank 0, the sharded one again (the first, unsharded solve
     is the cold call). On the card one ``all_reduce`` of 9 floats is
     timed.

The reference's checks 3 and 4 (the sharded ``DiffusionBatcher`` and
device-resident serving) wait for serving (ROADMAP A7).

Prints one JSON line with the results; exits non-zero on any failure.

  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cpu --world 4
  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cuda --backend nccl --world 1 --arch highres_dit
  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cuda --backend gloo --world 2 --arch highres_dit
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import socket
import sys
import tempfile
import time

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
        if mesh.size == 1:
            out["ok"] = out["bitwise_equal"]
        else:
            out["ok"] = (rec["finite"] and rec["converged"] == kw["batch"]
                         and nfe_diff <= NFE_SLACK)
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
               "fused_kernel": check_fused_kernel(mesh1d, mesh2d, dev)}
        if opts["arch"]:
            res["arch"] = check_arch(mesh1d, dev, opts["arch"])
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
    if arch:
        results["arch"] = ranks[0]["arch"]
        results["arch"]["launches_per_rank"] = [r["arch"]["launches"] for r in ranks]
        ok &= bool(results["arch"]["ok"])
        if device == "cuda":  # the kernels ran on every rank
            ok &= all(r["arch"]["launches"]["sharded_solver_step"] > 0
                      and r["arch"]["launches"]["flash_attention"] > 0 for r in ranks)
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
