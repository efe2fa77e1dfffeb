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
     kernels' launches are counted from 0 over each mesh serve;
  7. with ``--arch``, the pipelined forward of that DiT
     (``launch/sample.py::make_pipelined_dit_forward``, batch
     ``PIPE_BATCH``, ``PIPE_MICROBATCHES`` microbatches) on a
     ``("pod", "data", "model")`` mesh of (world, 1, 1): each rank holds
     its stage's blocks (``shard_dit`` under ``_dit_param_shardings``
     with the pipeline axis "pod"), and every rank's output is bitwise
     the whole model's forward with its blocks run microbatch by
     microbatch; K3's launches, the stage handoffs and the broadcast are
     counted. At world 1, one adaptive solve through
     ``make_sample_step(forward_fn=pipelined)`` (VP, eps_rel 0.05, fused
     step) as ``sample(mesh=)`` on that mesh, called three times
     (``graphed_calls``): every sample finite and converged, NFE within
     ``NFE_SLACK`` of ``sample`` through the unsharded forward, K4 and K3
     launched; on an NCCL mesh graphed (captures 0, 1, 0), each call
     bitwise the first, host-driven one;
  8. with ``--arch``, the tensor-parallel forward of that DiT on the
     ``("data", "model")`` mesh of (world/2, 2) (1 × 1 at world 1): bitwise
     the unsharded forward at world 1, within ``TP_TOL``·(1 + max|out|)
     of it otherwise; the collectives of the forward by kind (the books);
     and the forward counted on meta tensors for the same rank of the
     same mesh without process groups (``collectives.counting``) equal to
     those books, call for call and byte for byte. At world 1 an
     adaptive solve through that forward, called three times as check 7's;
  9. with ``--arch``, the graphed sharded solves (``check_graphed``):
     ``sample(mesh=)`` of that DiT (batch 8, VP, fused step, flash
     attention) adaptive at eps_rel 0.05, EM at ``GRAPHED_STEPS["em"]``
     steps, PC at ``GRAPHED_STEPS["pc"]``, the ODE at rtol 1e-3, each
     called three times under the one-shot rule: on an NCCL mesh the
     first runs the host-driven sharded loop, the second captures, the
     third replays, each graphed call bitwise the first (x, nfe, accepted,
     rejected, iterations) with at most 2 host reads, the replay's K4,
     K3, K5 and P1 launches the first call's and P2 once a horizon plus
     one. A gloo mesh on the card cannot be captured: there the adaptive
     solve runs twice, host-driven, and the record says so
     (``graphed: false``).

On the card one ``all_reduce`` of 9 floats is timed.

With ``--lm-arch`` the self-test checks a language model under a
``("data", "model")`` mesh instead (``--mesh D,M``, D·M = ``--world``):
each rank builds its shard (``init_model(mesh=)``, seed 0; ``--lm-reduced``
the scaled-down config), prefills seeded
prompts through K3/K7 on its heads (``--lm-prefill B,S``) and decodes
``--lm-decode B,STEPS`` greedy steps from seeded first tokens
(``--flash-decode``: with ``decode_flash_shard="model"``). Every rank
counts its K3 and K7 launches, the LM collectives of the prefill and of
a decode step and their bytes; rank 0 writes the record (last-position
logits, every decode step's logits, the tokens, the MoE routing) to
``--lm-out``. Each rank then counts the dry run's prefill and decode
step (``specs.build_dryrun``, ``meta_books``) on meta tensors for its
coordinate of a mesh of the same shape without process groups
(``collectives.counting``): the counts must equal the real run's books
(the prefill and the first decode step, each with its tokens picked
over the rank's vocab columns and gathered to every rank as the dry
run's steps return them), call for call and byte for byte, by the
reference's op kinds and by the port's (``meta_equal``); every pick is
bitwise ``torch.argmax`` of the gathered logits (``pick_bitwise``).
Given ``--lm-record`` (an unsharded record from ``lm_record``) the run
feeds that record's tokens (teacher forcing) and
compares: logits within ``LM_TOL``·max|logit|, greedy tokens equal
except where the record's top-2 gap is within that bound, and every
rank's residual and tokens the same bits. ``--lm-plan FILE`` runs a JSON
list of such runs (keys as the flags: arch, reduced, mesh, flash_decode,
prefill, decode, record, out; and layers, a depth cut; tol, the bound;
also_flash, a second decode with the lever; graphed, the serve step
under the mesh against its eager step, ``graphed_decode``: on an NCCL
mesh graphed, tokens and state bitwise, one capture, a replay's books
the dry run's meta count) in one spawn, building and freeing the models
in turn.

``--train-plan FILE`` runs a JSON list of LM training runs under a mesh
(keys: arch, reduced, layers, mesh, layout ("tp", "fsdp", "zero1";
``launch.specs.train_layout``), remat, steps, batch, seq, lr, seed;
record, the path of an unsharded record from ``train_record``, or
reference "self": each rank first trains the unsharded port itself, on
its device, all ranks at once, kept a key at a time; grads_only, that
record the first batch's gradients alone; keep, to hold the run's
first-step blocks for a later run's same_bits_as (its index); kind "train_loop":
``train_loop`` unsharded, then under the mesh, every loss and the final
shard compared bit for bit). Each rank builds its shard
(``init_model(mesh=)``, seed 0; the ZeRO-3 layout's data blocks cut
from it), trains ``steps`` steps of ``synth_batch`` (every rank the same
batch, its rows kept) with ``AdamW`` at a constant lr, and reports the
first step's loss, ce, aux and clip scale (with its bits), each leaf's
gradient block and new block against the record's (the CPU tests'
bounds: 2e-4·(1 + max|g|); the update 2e-4·(1 + max|update|) where
|g|·clip > ``WELL_CONDITIONED``, else 2·lr), every step's loss (within
``TRAIN_LOSS_RTOL``), its wall, the collectives and bytes of each step
by kind, the first step's books by the reference's op kinds (``ops``:
where the head is cut over "model" no all-gather of the logits, the
loss being the vocab-parallel cross-entropy), the peak (the card) and
the run's wall (``run_s``). Each rank
counts the dry run's train step of its layout on meta tensors for its
coordinate (``meta_books``), which must equal the first step's books
(``meta_equal``). The result line adds the cross-rank checks: every
rank's losses and clip scale the same bits.

Prints one JSON line with the results; exits non-zero on any failure.

  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cpu --world 4
  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cuda --backend nccl --world 1 --arch highres_dit
  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cuda --backend gloo --world 2 --arch highres_dit
  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cpu --world 2 --lm-arch gemma3-12b --lm-reduced --mesh 1,2
  PYTHONPATH=src python -m repro_torch.launch.sharded_selftest --device cpu --world 2 --train-plan plan.json
"""

from __future__ import annotations

import argparse
import contextlib
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
#: check 9's fixed grids: steps of EM and of PC
GRAPHED_STEPS = {"em": 60, "pc": 30}
#: checks 7 and 8: the DiT's batch and the pipeline's microbatches
PIPE_BATCH, PIPE_MICROBATCHES = 8, 4
#: check 8: the tensor-parallel forward against the unsharded one, times
#: 1 + max|out| (the fp32 DiT parity tolerance of tests/test_torch_dit.py)
TP_TOL = 1e-4
#: the LM check's logits bound, times max|logit| (chip_smoke.py's LM_LOGIT_TOL)
LM_TOL = 1e-3
#: the training check's bounds, tests/test_torch_lm_train.py's: a step's loss
#: (relative), a gradient leaf (times 1 + max|g|), an update (times 1 + max|update|
#: where the clipped gradient is above WELL_CONDITIONED, else 2·lr)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 2e-4
WELL_CONDITIONED = 1e3 * 1e-8


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world: int, *args) -> list:
    """Run ``fn(rank, world, port, out_dir, *args)`` on ``world`` spawned
    ranks and return what each pickled to ``out_dir/rank{r}.pkl`` (a file
    each: results through a pipe would block a rank until the parent
    reads, and the parent reads after every rank has ended). Raises if a
    rank raises. At world 1 the one rank runs in this process (a new
    process takes seconds to reach the card); the thread count
    ``init_rank`` sets is restored after."""
    with tempfile.TemporaryDirectory() as out_dir:
        if world == 1:
            threads = torch.get_num_threads()
            try:
                fn(0, 1, free_port(), out_dir, *args)
            finally:
                torch.set_num_threads(threads)
        else:
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


def _arch_model(arch: str, dev, *, flash: bool = True):
    """``arch``'s DiT (weights from seed 0, livened from seed 0) and a
    ``PIPE_BATCH`` input drawn from seed 7."""
    from repro_torch.configs.diffusion import ARCHS
    from repro_torch.models.dit import init_dit, liven_zero_init

    net = dataclasses.replace(ARCHS[arch], use_flash=flash)
    model = init_dit(net, torch.Generator(device=dev).manual_seed(0))
    liven_zero_init(model, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(PIPE_BATCH, net.image_size, net.image_size, net.channels, generator=gen,
                    device=dev)
    t = torch.rand(PIPE_BATCH, generator=gen, device=dev) * 0.9 + 0.1
    return net, model, x, t


def _timed(fn, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def microbatched_forward(model, x, t, microbatches: int, policy=None):
    """The whole ``model``'s blocks run on ``microbatches`` blocks of rows
    in turn, the embedding and the head on the whole batch: what a GPipe
    pipeline computes (check 7's expected value)."""
    h, temb, cw = model.embed(x, t, policy=policy)
    h = torch.cat([model.run_blocks(hb, tb, cw) for hb, tb in
                   zip(h.chunk(microbatches), temb.chunk(microbatches))])
    return model.head(h, temb, cw)


def check_pipeline(dev, arch: str, world: int) -> dict:
    """Check 7: the pipelined forward of ``arch`` over "pod" against the
    whole model's blocks run microbatch by microbatch; at world 1 a solve
    through it (``_mesh_solve``)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.sample import _dit_param_shardings, make_pipelined_dit_forward
    from repro_torch.models.dit import shard_dit
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import init_mesh

    t0 = time.perf_counter()
    mesh = init_mesh(1, 1, device=dev, pod=world)
    net, full, x, t = _arch_model(arch, dev)
    model = shard_dit(full, _dit_param_shardings(net, mesh, pipeline_axis="pod"))
    fwd = make_pipelined_dit_forward(model, num_microbatches=PIPE_MICROBATCHES, mesh=mesh)
    with torch.no_grad():
        want, want_s = _timed(lambda: microbatched_forward(full, x, t, PIPE_MICROBATCHES), dev)
        fwd(model, x, t)  # warm
        coll.reset()
        flash_ops.launches = 0
        got, got_s = _timed(lambda: fwd(model, x, t), dev)
    books = coll.counts()
    out = {"mesh": list(mesh.sizes), "stage": mesh.coord("pod"),
           "layers": [model.layer_range.start, model.layer_range.stop],
           "bitwise_equal": bool(torch.equal(got, want)),
           "max_abs_diff": float((got - want).abs().max()),
           "k3_launches": flash_ops.launches,
           "handoffs": list(books.get("stage_handoff", (0, 0))),
           "broadcasts": list(books.get("stage_broadcast", (0, 0))),
           "wall_s": got_s, "microbatched_wall_s": want_s}
    if world == 1:
        out["solve"] = _mesh_solve(dev, mesh, full, model, fwd)
    del full, model
    out["seconds"] = time.perf_counter() - t0
    return out


def _launch_counts() -> dict:
    """The kernel wrappers' launch counts a graphed solve charges."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.graph_loop import ops as loop_ops
    from repro_torch.kernels.philox import ops as philox_ops
    from repro_torch.kernels.solver_step import ops as step_ops

    return {"K1": step_ops.launches, "K4": step_ops.sharded_launches,
            "K3": flash_ops.launches, "K5": step_ops.em_launches,
            "P1": philox_ops.launches, "P2": loop_ops.launches}


def graphed_calls(solve, dev, n: int = 3) -> dict:
    """``solve()`` (a ``SolveResult``) called ``n`` times: each call's
    drivers built and captures (``adaptive.builds``, ``adaptive.captures``:
    on the CPU no capture), host reads (``adaptive.host_syncs``),
    kernel launches (``_launch_counts``) and wall, on the card its window
    share (the elapsed device time of its driver windows, CUDA events
    around each, over its wall; None for a host-driven call: the
    profiler cannot trace a WHILE node), and whether each
    later call is the first bit for bit (x, nfe, accepted, rejected,
    iterations). Returns those lists, the first call's iterations, mean
    NFE, convergence and finiteness, and the first result."""
    from repro_torch.core.solvers import adaptive as ad

    from repro_torch.benchmarks.kernel_times import window_events

    out = {"builds": [], "captures": [], "host_reads": [], "launches": [], "walls_s": [],
           "window_share": [], "bitwise": []}
    first = None
    for _ in range(n):
        b0, c0, r0, l0 = ad.builds, ad.captures, ad.host_syncs, _launch_counts()
        _sync(dev)
        with (window_events() if dev.type == "cuda" else contextlib.nullcontext([])) as spans:
            t0 = time.perf_counter()
            res = solve()
            _sync(dev)
            wall = time.perf_counter() - t0
        out["walls_s"].append(wall)
        out["window_share"].append(sum(e0.elapsed_time(e1) for e0, e1 in spans) / 1e3 / wall
                                   if spans else None)
        out["builds"].append(ad.builds - b0)
        out["captures"].append(ad.captures - c0)
        out["host_reads"].append(ad.host_syncs - r0)
        out["launches"].append({k: v - l0[k] for k, v in _launch_counts().items()})
        if first is None:
            first = res
        out["bitwise"].append(all(torch.equal(getattr(res, f), getattr(first, f))
                                  for f in ("x", "nfe", "accepted", "rejected", "iterations")))
    out.update(iterations=int(first.iterations), mean_nfe=float(first.nfe.float().mean()),
               finite=bool(torch.isfinite(first.x).all()), result=first)
    return out


def graphed_ok(rec: dict, horizons: int) -> bool:
    """A ``graphed_calls`` record of three calls on a capturable mesh:
    drivers built 0, 1, 0 (on the card each a capture), every call the
    first bit for bit, at most 2 host reads a graphed call, and on the
    card the replay's K4, K3, K5 and P1 launches the first call's and P2
    ``horizons`` + 1."""
    ok = rec["builds"] == [0, 1, 0] and all(rec["bitwise"])
    ok &= all(n <= 2 for n in rec["host_reads"][1:])
    host, replay = rec["launches"][0], rec["launches"][2]
    if any(host.values()):  # the card's counts (the CPU launches nothing)
        ok &= rec["captures"] == rec["builds"]
        ok &= all(replay[k] == host[k] for k in ("K4", "K3", "K5", "P1"))
        ok &= replay["P2"] == horizons + 1
    return bool(ok)


def solve_horizons_of(method: str, rec: dict) -> int:
    """The horizons a graphed solve of ``method`` runs: one a step of a
    fixed grid, one a group of ``SYNC_EVERY`` iterations otherwise."""
    from repro_torch.core.solvers.adaptive import SYNC_EVERY

    if method in GRAPHED_STEPS:
        return GRAPHED_STEPS[method]
    return -(-rec["iterations"] // SYNC_EVERY)


def check_graphed(mesh, dev, arch: str) -> dict:
    """Check 9: ``sample(mesh=)`` of ``arch`` (seed-0 weights, livened;
    batch 8, VP, fp32) adaptive, EM, PC and the ODE, three calls each
    (``graphed_calls``; module docstring). On a gloo mesh on the card the
    adaptive solve alone, twice, host-driven."""
    from repro_torch.core.sampling import sample
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.launch.sample import build_score

    t0 = time.perf_counter()
    net, _, score = build_score(arch, flash=True, precision="fp32", seed=0, liven_seed=0,
                                device=dev)
    shape = (PIPE_BATCH, net.image_size, net.image_size, net.channels)
    graphed = dev.type == "cpu" or ad.mesh_capturable(mesh.group())
    solves = (("adaptive", dict(eps_rel=0.05, use_fused_kernel=True, max_iters=400)),
              ("em", dict(n_steps=GRAPHED_STEPS["em"])), ("pc", dict(n_steps=GRAPHED_STEPS["pc"])),
              ("ode", dict(rtol=1e-3, atol=1e-3)))
    out = {"graphed": graphed}
    for method, kw in (solves if graphed else solves[:1]):
        rec = graphed_calls(lambda: sample(VPSDE(), score, shape, seed=0, method=method,
                                           device=dev, mesh=mesh, **kw), dev,
                            n=3 if graphed else 2)
        del rec["result"]
        rec["horizons"] = solve_horizons_of(method, rec)
        rec["ok"] = graphed_ok(rec, rec["horizons"]) if graphed else (
            rec["builds"] == [0, 0] and all(rec["bitwise"]))
        out[method] = rec
    out["seconds"] = time.perf_counter() - t0
    return out


def _mesh_solve(dev, mesh, full, model, forward_fn=None) -> dict:
    """Checks 7 and 8 at world 1: an adaptive solve (VP, eps_rel 0.05,
    fused step) through ``forward_fn`` on ``model`` as ``sample(mesh=)``,
    three calls (``graphed_calls``), against ``sample`` through the
    unsharded ``full`` model."""
    from repro_torch.core.sampling import sample
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.launch.sample import _converged, make_sample_step

    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, max_iters=400)
    shape = (PIPE_BATCH, full.cfg.image_size, full.cfg.image_size, full.cfg.channels)
    score = make_sample_step(sde, cfg, forward_fn=forward_fn).score_of(model)
    with torch.no_grad():
        ref, ref_s = _timed(lambda: sample(sde, make_sample_step(sde, cfg).score_of(full),
                                           shape, seed=0, device=dev, config=cfg), dev)
        calls = graphed_calls(lambda: sample(sde, score, shape, seed=0, device=dev, mesh=mesh,
                                             config=cfg), dev)
    res = calls.pop("result")
    host = calls["launches"][0]
    calls["horizons"] = solve_horizons_of("adaptive", calls)
    return {"k1_launches": host["K1"], "k4_launches": host["K4"], "k3_launches": host["K3"],
            "iterations": int(res.iterations), "mean_nfe": float(res.nfe.float().mean()),
            "unsharded_mean_nfe": float(ref.nfe.float().mean()),
            "max_nfe_diff": int((res.nfe - ref.nfe).abs().max()),
            "finite": bool(torch.isfinite(res.x).all()),
            "converged": _converged(res, cfg.max_iters),
            "wall_s": calls["walls_s"][0], "unsharded_wall_s": ref_s, "calls": calls,
            "graphed_ok": graphed_ok(calls, calls["horizons"])}


def check_tensor_parallel(mesh, dev, arch: str) -> dict:
    """Check 8: the tensor-parallel forward of ``arch`` on ``mesh`` against
    the unsharded forward, and its books against its meta count."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.dryrun import count
    from repro_torch.launch.sample import _dit_param_shardings
    from repro_torch.models.dit import DiT, shard_dit
    from repro_torch.parallel import Mesh
    from repro_torch.parallel import collectives as coll

    t0 = time.perf_counter()
    net, full, x, t = _arch_model(arch, dev)
    model = shard_dit(full, _dit_param_shardings(net, mesh))
    with torch.no_grad():
        want, want_s = _timed(lambda: full(x, t), dev)
        model(x, t, mesh=mesh)  # warm
        coll.reset()
        flash_ops.launches = 0
        got, got_s = _timed(lambda: model(x, t, mesh=mesh), dev)
        books, ops = coll.counts(), coll.op_counts()
        meta = torch.device("meta")
        place = Mesh(mesh.axis_names, mesh.sizes, mesh.coordinate, device=meta)
        mnet = dataclasses.replace(net, use_flash=False)  # kernel wrappers refuse meta
        shadow = DiT(mnet, device=meta, shardings=_dit_param_shardings(mnet, place))
        coll.reset()
        with coll.counting():
            count(lambda a, b: shadow(a, b, mesh=place), x.to(meta), t.to(meta))
        counted, counted_ops = coll.counts(), coll.op_counts()
    coll.reset()
    err = float((got - want).abs().max())
    bound = TP_TOL * (1 + float(want.abs().max()))
    blk = model.blocks[0]
    out = {"mesh": list(mesh.sizes), "coordinate": list(mesh.coordinate),
           "layers": len(model.blocks), "heads": blk.wq.shape[1], "ffn": blk.w_in.shape[1],
           "ada": blk.ada.shape[1],
           "bitwise_equal": bool(torch.equal(got, want)), "max_abs_diff": err,
           "bound": bound, "within_bound": err <= bound,
           "k3_launches": flash_ops.launches,
           "books": {k: {"calls": v[0], "mb": v[1] / 1e6} for k, v in ops.items()},
           "port_kinds": {k: {"calls": v[0], "mb": v[1] / 1e6} for k, v in books.items()},
           "meta_equal": counted_ops == ops and counted == books,
           "wall_s": got_s, "unsharded_wall_s": want_s}
    if mesh.size == 1:
        out["solve"] = _mesh_solve(dev, mesh, full, model,
                                   lambda m, x, t: m(x, t, mesh=mesh))
    del full, model
    out["seconds"] = time.perf_counter() - t0
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


# --------------------------------------------------------------------------
# the language models under a mesh
# --------------------------------------------------------------------------

def lm_config(arch: str, *, layers: int | None = None, reduced: bool = False):
    """The registered config of ``arch``, scaled down with ``reduced``, cut
    to ``layers`` layers (a multiple of its pattern) where given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.scaled_down()
    return cfg.replace(num_layers=layers) if layers else cfg


def lm_inputs(cfg, prefill, decode, seed: int = 0) -> dict:
    """Seeded CPU inputs: prompts (B, S[, K]), the decode's first tokens
    (B_d, 1[, K]) and, for cross-attention, image embeddings for each."""
    g = torch.Generator().manual_seed(seed)
    K = cfg.num_codebooks
    shape = lambda b, s: (b, s, K) if K > 1 else (b, s)
    out = {"prompts": torch.randint(0, cfg.vocab_size, shape(*prefill), generator=g),
           "first": torch.randint(0, cfg.vocab_size, shape(decode[0], 1), generator=g)}
    if cfg.vision_dim:
        for key, b in (("cross_prefill", prefill[0]), ("cross_decode", decode[0])):
            out[key] = torch.randn(b, cfg.num_patches, cfg.vision_dim, generator=g)
    return out


def _counters():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.parallel import collectives as coll

    return {"K3": flash_ops.launches, "K7": ssd_ops.launches, "collectives": coll.calls,
            "collective_bytes": coll.nbytes}


def _zero_counters():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.parallel import collectives as coll

    flash_ops.launches = ssd_ops.launches = 0
    coll.reset()


def _books() -> dict:
    """The collectives since the last reset: by the reference's op kinds
    and by the port's, each {kind: (calls, bytes)}."""
    from repro_torch.parallel import collectives as coll

    return {"ops": coll.op_counts(), "kinds": coll.counts()}


def meta_place(mesh):
    """This rank's place on ``mesh`` as a mesh without process groups, on
    the meta device (what a dry run counts)."""
    from repro_torch.parallel import Mesh

    return Mesh(mesh.axis_names, mesh.sizes, mesh.coordinate, device=torch.device("meta"))


def meta_books(cfg, mesh, shape, *, fsdp: bool = False, zero1: bool = False,
               remat: str = "none") -> dict:
    """The dry run's step of ``shape`` (an ``InputShape``: its rows,
    length and kind), built by ``specs.build_dryrun`` for this rank's
    coordinate of ``mesh`` and counted on meta tensors inside
    ``collectives.counting`` (the plain attention and SSD, as the dry run
    counts): its books (``_books``) and the count's ``seconds``."""
    from repro_torch.launch import specs
    from repro_torch.parallel import collectives as coll

    t0 = time.perf_counter()
    spec = specs.build_dryrun(cfg, shape, meta_place(mesh), dtype=cfg.dtype, fsdp=fsdp,
                              zero1=zero1, remat=remat)
    coll.reset()
    with coll.counting():
        spec.fn(*spec.args)
    out = {"books": _books(), "seconds": time.perf_counter() - t0}
    coll.reset()
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_record(cfg, params, inputs: dict, decode_steps: int, dev, *, mesh=None,
              feed=None, prefill: bool = True) -> dict:
    """Prefill and decode ``cfg`` (``params``: the whole model, or the rank's
    shard on ``mesh``) on ``inputs`` (``lm_inputs``): the prefill of every
    prompt with the head on the last position (K3/K7 through the default
    paths), then ``decode_steps`` greedy steps from ``first`` over a cache
    of twice the steps. ``feed`` (a record's ``decode_tokens``) makes the
    steps teacher-forced. Returns the record: ``prefill_logits`` (B, V[,…])
    and ``decode_logits`` (steps, B_d, …) of every row on CPU,
    ``decode_tokens`` fed and ``decode_choices`` taken, the MoE routing of
    the prefill, the residual the final norm read, walls, and the
    counters (K3/K7 launches and LM collectives of the prefill with its
    pick, the collectives of a mean decode step), and the books
    (``_books``) of the prefill and of the first decode step, each with
    its tokens picked over the rank's vocab columns and gathered to every
    rank as ``make_prefill_step`` and ``make_serve_step`` do (the books
    of the dry run's steps; the logits' gathers for the record, over the
    vocab and the rows, come after), and ``pick_bitwise``: every pick
    bitwise ``torch.argmax`` of the gathered logits. ``prefill=False``
    decodes only."""
    from repro_torch.launch.steps import greedy_tokens
    from repro_torch.models import transformer as tr
    from repro_torch.parallel.collectives import all_gather_dim, gather_rows
    from repro_torch.parallel.sharding import batch_sharding

    def cut(t, rows):
        return t if rows is None else t[rows.rows]

    def whole(t, rows):
        return t if rows is None else gather_rows(t.contiguous(), mesh, rows)

    def vocab(lg, v0):  # the rank's vocab columns (ids from v0) gathered
        return lg if v0 is None else all_gather_dim(lg, -1, mesh, backward="own")

    rec = {"pick_bitwise": True}
    if prefill:
        rec.update(_lm_prefill(cfg, params, inputs, dev, mesh, cut, whole, vocab))

    first = inputs["first"]
    B = first.shape[0]
    rows_d = None if mesh is None else batch_sharding(mesh, B, 2)
    cross_d = inputs.get("cross_decode")
    state = tr.init_decode_state(cfg, B, 2 * decode_steps, device=dev, mesh=mesh)
    tok = first
    fed, choices, step_logits = [], [], []
    _sync(dev)
    _zero_counters()
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(decode_steps):
            fed.append(tok)
            (lg, v0), state = tr.decode_step(
                params, cut(tok, rows_d).to(dev), state, cfg,
                cross_embeds=None if cross_d is None else cut(cross_d, rows_d).to(dev),
                mesh=mesh, rows=rows_d, vocab_local=True)
            # the serve step's tokens (B, 1[, K]), every row
            pick = greedy_tokens(lg, v0, mesh)
            choice = whole(pick.to(torch.int32), rows_d)
            if t == 0:
                rec["decode_books"] = _books()
            lg = vocab(lg, v0)
            rec["pick_bitwise"] &= bool(torch.equal(pick, torch.argmax(lg, dim=-1)))
            choice = choice[:, 0].to(torch.int64).cpu()
            lg = whole(lg[:, 0], rows_d).float()
            choices.append(choice)
            step_logits.append(lg.cpu())
            tok = (feed[t + 1] if feed is not None and t + 1 < len(feed)
                   else choice).reshape(first.shape)
    _sync(dev)
    rec["decode_s"] = time.perf_counter() - t0
    counts = _counters()
    rec["decode_step_counts"] = {k: v / decode_steps for k, v in counts.items()}
    rec["decode_logits"] = torch.stack(step_logits)
    rec["decode_tokens"] = torch.stack(fed)
    rec["decode_choices"] = torch.stack(choices)
    return rec


def _lm_prefill(cfg, params, inputs, dev, mesh, cut, whole, vocab) -> dict:
    """``lm_record``'s prefill."""
    from repro_torch.launch.steps import greedy_tokens
    from repro_torch.models import transformer as tr
    from repro_torch.parallel.sharding import batch_sharding

    prompts = inputs["prompts"]
    rows = None if mesh is None else batch_sharding(mesh, prompts.shape[0], 2)
    cross = inputs.get("cross_prefill")
    routing = [] if cfg.moe is not None else None
    residual = []
    _sync(dev)
    _zero_counters()
    t0 = time.perf_counter()
    with torch.no_grad():
        (logits, v0), _ = tr.forward(
            params, cut(prompts, rows).to(dev), cfg,
            cross_embeds=None if cross is None else cut(cross, rows).to(dev),
            last_logits_only=True, mesh=mesh, rows=rows, moe_routing=routing,
            residual=residual, vocab_local=True)
        pick = greedy_tokens(logits[:, -1:], v0, mesh)
    _sync(dev)
    rec = {"prefill_s": time.perf_counter() - t0, "prefill_counts": _counters()}
    # the prefill step's tokens, every row, as make_prefill_step returns them
    whole(pick.to(torch.int32), rows)
    rec["prefill_books"] = _books()
    logits = vocab(logits, v0)
    rec["pick_bitwise"] = bool(torch.equal(pick, torch.argmax(logits[:, -1:], dim=-1)))
    rec["prefill_logits"] = whole(logits[:, -1], rows).float().cpu()
    rec["residual"] = residual[0].cpu()
    rec["routing"] = None if routing is None else [
        {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in r.items()} for r in routing]
    return rec


def top2_gap(logits) -> float:
    top = torch.topk(logits.float().reshape(-1), 2).values
    return (top[0] - top[1]).item()


def compare_lm(got: dict, want: dict, tol: float = LM_TOL) -> dict:
    """A record against the unsharded one: bitwise, the logits' max error
    against ``tol``·max|logit| (prefill; decode over every step), and the
    greedy choices that differ whose top-2 gap in ``want`` exceeds that
    bound (none may)."""
    out = {"bitwise": all(torch.equal(got[k], want[k]) for k in
                          ("prefill_logits", "decode_logits", "decode_choices"))}
    for key in ("prefill_logits", "decode_logits"):
        scale = want[key].abs().max().item()
        err = (got[key] - want[key]).abs().max().item()
        out[key] = {"max_abs_err": err, "scale": scale, "bound": tol * scale,
                    "ok": bool(torch.isfinite(got[key]).all()) and err <= tol * scale}
    bad, near = [], 0
    pairs = [(got["prefill_logits"].argmax(-1), want["prefill_logits"].argmax(-1),
              want["prefill_logits"], out["prefill_logits"]["bound"])]
    pairs += [(got["decode_choices"][t], want["decode_choices"][t], want["decode_logits"][t],
               out["decode_logits"]["bound"]) for t in range(len(want["decode_choices"]))]
    for g, w, logits, bound in pairs:
        for idx in (g != w).nonzero().tolist():
            gap = top2_gap(logits[tuple(idx)])
            if gap > bound:
                bad.append((idx, gap))
            else:
                near += 1
    out["token_mismatches_near_tie"] = near
    out["token_mismatches"] = len(bad)
    out["ok"] = out["prefill_logits"]["ok"] and out["decode_logits"]["ok"] and not bad
    return out


def graphed_decode(cfg, params, inputs: dict, steps: int, dev, mesh, want_books: dict) -> dict:
    """The serve step under ``mesh`` (``make_serve_step(mesh=)``: on an NCCL
    mesh a ``GraphedServeStep``) against its eager step, each ``steps``
    greedy steps from ``inputs``' first tokens on a fresh decode state
    (a cache of twice the steps, the dry run's): the tokens and the final
    state bitwise, one capture, the books of a replayed step (the third)
    equal to ``want_books`` (the dry run's decode step counted on meta
    tensors), and ms a step of each after the first. A mesh whose step
    stays eager (gloo) gives ``graphed: false``."""
    from repro_torch.launch.serve import state_tensors
    from repro_torch.launch.steps import GraphedServeStep, make_serve_step
    from repro_torch.models import transformer as tr

    step = make_serve_step(cfg, device=dev, mesh=mesh)
    if not isinstance(step, GraphedServeStep):
        return {"graphed": False}
    first = inputs["first"].to(dev)
    cross = inputs.get("cross_decode")
    extra = {} if cross is None else {"cross_embeds": cross.to(dev)}
    runs = {}
    for name, fn in (("graphed", step), ("eager", step.eager)):
        state = tr.init_decode_state(cfg, first.shape[0], 2 * steps, device=dev, mesh=mesh)
        tok, toks, books = first, [], None
        for i in range(steps):
            if i == 1:
                _sync(dev)
                t0 = time.perf_counter()
            if i == 2:
                _zero_counters()
            tok, state = fn(params, {"tokens": tok, **extra}, state)
            if i == 2:
                books = _books()
            toks.append(tok)
        _sync(dev)
        runs[name] = (torch.cat(toks, 1), state_tensors(state), books,
                      (time.perf_counter() - t0) * 1e3 / (steps - 1))
    (tg, sg, bg, mg), (te, se, be, me) = runs["graphed"], runs["eager"]
    return {"graphed": True, "tokens_bitwise": bool(torch.equal(tg, te)),
            "state_bitwise": bool(sg) and all(torch.equal(a, b) for a, b in zip(sg, se)),
            "captures": step.captures, "build_s": step.build_s,
            "meta_equal": bg == want_books, "eager_books_equal": be == want_books,
            "graphed_ms_per_step": mg, "eager_ms_per_step": me}


def check_lm(mesh, dev, run: dict) -> list:
    """One LM run on this rank (the keys of ``--lm-plan``; ``also_flash``
    decodes the same shard a second time with ``decode_flash_shard=
    "model"``); rank 0 writes the record and compares it with the
    unsharded one. Returns a result a decode."""
    from repro_torch.configs import InputShape
    from repro_torch.models import transformer as tr
    from repro_torch.optim.tree import leaves

    cfg = lm_config(run["arch"], layers=run.get("layers"), reduced=run.get("reduced", False))
    want = torch.load(run["record"]) if run.get("record") else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    params = tr.init_model(cfg, 0, device=dev, mesh=mesh)
    _sync(dev)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None
    inputs = lm_inputs(cfg, tuple(run["prefill"]), tuple(run["decode"]))
    feed = None if want is None else want["decode_tokens"]
    results, prefill = [], None
    for flash in (bool(run.get("flash_decode")),) + ((True,) if run.get("also_flash") else ()):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rec = lm_record(cfg.replace(decode_flash_shard="model") if flash else cfg, params,
                        inputs, run["decode"][1], dev, mesh=mesh, feed=feed,
                        prefill=prefill is None)
        # the dry run's decode step (its cache of twice the steps) and
        # prefill, counted for this rank
        run_cfg = cfg.replace(decode_flash_shard="model") if flash else cfg
        B_d, steps = run["decode"]
        meta = {"decode": meta_books(run_cfg, mesh, InputShape("decode", 2 * steps, B_d,
                                                               "decode"))}
        if prefill is None:
            B_p, S_p = run["prefill"]
            meta["prefill"] = meta_books(run_cfg, mesh, InputShape("prefill", S_p, B_p,
                                                                   "prefill"))
        meta_equal = {k: m["books"] == rec[f"{k}_books"] for k, m in meta.items()}
        graphed = (graphed_decode(run_cfg, params, inputs, steps, dev, mesh,
                                  meta["decode"]["books"]) if run.get("graphed") else None)
        if prefill is None:
            prefill = {k: rec[k] for k in ("prefill_s", "prefill_counts", "prefill_logits",
                                           "residual", "routing", "prefill_books")}
        rec.update(prefill)
        out = {"arch": run["arch"], "layers": run.get("layers"), "mesh": list(mesh.sizes),
               "coordinate": list(mesh.coordinate), "flash_decode": flash,
               "build_s": build_s, "prefill_s": rec["prefill_s"], "decode_s": rec["decode_s"],
               "prefill_counts": rec["prefill_counts"],
               "decode_step_counts": rec["decode_step_counts"],
               "params_local": sum(t.numel() for t in leaves(params)),
               "meta_equal": meta_equal, "pick_bitwise": rec["pick_bitwise"],
               "meta_s": sum(m["seconds"] for m in meta.values()),
               "residual": rec["residual"], "choices": rec["decode_choices"],
               "prefill_tokens": rec["prefill_logits"].argmax(-1), "out": None}
        if graphed is not None:
            out["graphed_decode"] = graphed
        if dev.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            out["build_peak_gib"] = build_peak
        if dist.get_rank() == 0:
            if run.get("out"):
                out["out"] = run["out"] + (".flash" if results else "")
                torch.save(rec, out["out"])
            if want is not None:
                out["compare"] = compare_lm(rec, want, run.get("tol", LM_TOL))
        results.append(out)
        del rec
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return results


def _lm_rank_main(rank: int, world: int, port: int, out_dir: str, opts: dict) -> None:
    from repro_torch.parallel import init_mesh

    dev = init_rank(rank, world, port, opts["device"], opts["backend"])
    try:
        res = []
        for run in opts["plan"]:
            mesh = init_mesh(*run["mesh"], device=dev)
            res.extend(check_lm(mesh, dev, run))
        put_result(out_dir, rank, res)
    finally:
        dist.destroy_process_group()


def run_lm(world: int, plan: list, *, device: str = "cuda", backend: str | None = None) -> dict:
    """Spawn ``world`` ranks and run the LM ``plan`` (a list of run dicts);
    returns every run's per-rank results, the cross-rank checks and
    ``ok``."""
    backend = backend or default_backend(device, world)
    for run in plan:
        run.setdefault("mesh", [1, world])
        if run["mesh"][0] * run["mesh"][1] != world:
            raise ValueError(f"mesh {run['mesh']} does not cover {world} ranks")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu")
    t0 = time.perf_counter()
    ranks = spawn_ranks(_lm_rank_main, world, dict(device=device, backend=backend, plan=plan))
    runs, ok = [], True
    flat = [dict(run, flash_decode=flash) for run in plan
            for flash in (bool(run.get("flash_decode")),) + ((True,) if run.get("also_flash")
                                                           else ())]
    for i, run in enumerate(flat):
        per = [r[i] for r in ranks]
        by_data = {}
        for p in per:
            by_data.setdefault(p["coordinate"][0], []).append(p)
        same = all(torch.equal(p["residual"], g[0]["residual"])
                   for g in by_data.values() for p in g)
        same &= all(torch.equal(p["choices"], per[0]["choices"])
                    and torch.equal(p["prefill_tokens"], per[0]["prefill_tokens"]) for p in per)
        rec = {k: per[0][k] for k in ("arch", "layers", "mesh", "flash_decode", "out")}
        rec["ranks"] = [{k: v for k, v in p.items()
                         if k not in ("residual", "choices", "prefill_tokens", "compare")}
                        for p in per]
        rec["ranks_agree"] = bool(same)
        if "compare" in per[0]:
            rec["compare"] = per[0]["compare"]
            # at world 1 the mesh path is the unsharded arithmetic (the flash
            # lever's decode is another sum order)
            ok &= rec["compare"]["ok"] and (world > 1 or run["flash_decode"]
                                            or rec["compare"]["bitwise"])
        ok &= bool(same)
        # every greedy pick over the vocab columns is the gathered argmax
        rec["pick_bitwise"] = all(p["pick_bitwise"] for p in per)
        ok &= rec["pick_bitwise"]
        # every rank's meta count equals its books, each step
        rec["meta_equal"] = all(all(p["meta_equal"].values()) for p in per)
        ok &= rec["meta_equal"]
        if "graphed_decode" in per[0]:  # graphed where the mesh is NCCL's
            rec["graphed_decode"] = [p["graphed_decode"] for p in per]
            want_graphed = device == "cuda" and backend == "nccl"
            ok &= all(g["graphed"] == want_graphed and (not want_graphed or (
                g["tokens_bitwise"] and g["state_bitwise"] and g["captures"] == 1
                and g["meta_equal"])) for g in rec["graphed_decode"])
        if device == "cuda":  # the kernels ran on every rank, every layer
            cfg = lm_config(run["arch"], layers=run.get("layers"),
                            reduced=run.get("reduced", False))
            want = {"K3": sum(m in ("A", "L") for m in cfg.mixer_pattern) * cfg.num_repeats,
                    "K7": cfg.mixer_pattern.count("M") * cfg.num_repeats}
            rec["kernel_launches_expected"] = want
            ok &= all(p["prefill_counts"][k] == n for p in per for k, n in want.items())
        runs.append(rec)
    return {"world": world, "device": device, "backend": backend,
            "seconds": time.perf_counter() - t0, "lm": runs, "ok": bool(ok)}


# --------------------------------------------------------------------------
# LM training under a mesh
# --------------------------------------------------------------------------

def train_batches(cfg, batch: int, seq: int, steps: int, seed: int = 0) -> list:
    """Every step's batch as every rank draws it, on the CPU: ``synth_batch``
    tokens and, for cross-attention, one seeded draw of image embeddings."""
    from repro_torch.data.tokens import TokenPipelineConfig, synth_batch

    pipe = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                               num_codebooks=cfg.num_codebooks, seed=seed)
    cross = None
    if cfg.vision_dim:
        g = torch.Generator().manual_seed(seed)
        cross = torch.randn((batch, cfg.num_patches, cfg.vision_dim), generator=g)
    out = []
    for step in range(steps):
        b = {"tokens": synth_batch(pipe, step)}
        if cross is not None:
            b["cross_embeds"] = cross
        out.append(b)
    return out


def flat_tree(tree, prefix: str = "") -> dict:
    """A nested dict of tensors as {"a/b": tensor} in leaf order."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_tree(v, key + "/"))
        else:
            out[key] = v
    return out


def train_record(cfg, params, batches: list, dev, *, lr: float,
                 grads_only: bool = False) -> dict:
    """The unsharded port trained on ``batches`` (``params``: the whole
    model on ``dev``, spent): every step's loss and wall, and of the first
    step its loss, ce, aux, clip scale, each leaf's gradient and new
    value (on the CPU) and their maxima (``grad_max``; ``update_max``,
    the largest |new − old|). ``grads_only``: the first batch's loss and
    gradients alone (no optimizer state: a model twice the size fits)."""
    from repro_torch.launch.steps import make_loss_fn, make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.optim.tree import leaves

    if grads_only:
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        b = {k: v.to(dev) for k, v in batches[0].items()}
        _sync(dev)
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, ce, aux = make_loss_fn(cfg)(params, b)
            grads = torch.autograd.grad(loss, flat)
        _sync(dev)
        rec = {"losses": [float(loss)], "step_s": [time.perf_counter() - t0],
               "loss": float(loss), "ce": float(ce), "aux": float(aux)}
        if dev.type == "cuda":  # the step's peak, before the record's own temporaries
            rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        names = list(flat_tree(params))
        rec.update(grad_max={k: float(g.abs().max()) for k, g in zip(names, grads)},
                   grads={k: g.to("cpu", copy=True) for k, g in zip(names, grads)})
        return rec

    opt = AdamW(lr=lr)
    state = opt.init(params)
    step = make_train_step(cfg, opt, device=dev)
    # the first step's inputs on the host, off the device's peak
    old = {k: v.detach().to("cpu", copy=True) for k, v in flat_tree(params).items()}
    rec = {"losses": [], "step_s": []}
    peak0 = 0.0
    for i, b in enumerate(batches):
        seen = {} if i == 0 else None
        _sync(dev)
        t0 = time.perf_counter()
        params, state, m = step(params, state, b, record=seen)
        _sync(dev)
        rec["step_s"].append(time.perf_counter() - t0)
        rec["losses"].append(float(m["loss"]))
        if i == 0:  # the step's peak, then the record's own temporaries
            if dev.type == "cuda":
                peak0 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            grads, new = flat_tree(seen["grads"]), flat_tree(params)
            rec.update(loss=float(m["loss"]), ce=float(m["ce"]), aux=float(m["moe_aux"]),
                       clip_scale=float(seen["clip_scale"]),
                       grad_max={k: float(g.abs().max()) for k, g in grads.items()},
                       update_max={k: float((new[k].detach() - old[k].to(dev)).abs().max())
                                   for k in new},
                       grads={k: g.to("cpu", copy=True) for k, g in grads.items()},
                       new={k: p.detach().to("cpu", copy=True) for k, p in new.items()})
            del seen, grads, old
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
    if dev.type == "cuda":
        rec["peak_gib"] = max(peak0, torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    return rec


def hold_train_step(got: dict, want: dict, shardings: dict, dev, lr: float) -> dict:
    """A rank's first-step blocks (``got``: "grads", "new", flat) against an
    unsharded record, leaf by leaf on ``dev``: each block's max abs error
    and its bound (``TRAIN_GRAD_TOL``; the update's where the record's
    clipped gradient is above ``WELL_CONDITIONED``, else 2·lr). Returns
    the worst ratios and errors and the leaves they fell on."""
    out = {"grad_ratio": 0.0, "new_ratio": 0.0, "grad_err": 0.0, "new_err": 0.0,
           "grad_leaf": None, "new_leaf": None}
    clip = want.get("clip_scale")
    for key, g in got["grads"].items():
        sh = shardings[key]
        g_ref = sh.local(want["grads"][key]).to(dev)
        err = (g.float() - g_ref).abs().max().item() if g.numel() else 0.0
        ratio = err / (TRAIN_GRAD_TOL * (1 + want["grad_max"][key]))
        if ratio >= out["grad_ratio"]:
            out.update(grad_ratio=ratio, grad_leaf=key)
        out["grad_err"] = max(out["grad_err"], err)
        if "new" not in want:  # a gradients-only record
            continue
        p_ref = sh.local(want["new"][key]).to(dev)
        diff = (got["new"][key].float() - p_ref).abs()
        sharp = g_ref.abs() * clip > WELL_CONDITIONED
        bound = TRAIN_GRAD_TOL * (1 + want["update_max"][key])
        r_sharp = (diff[sharp].max().item() / bound) if bool(sharp.any()) else 0.0
        r_flat = diff.max().item() / (2 * lr) if diff.numel() else 0.0
        ratio = max(r_sharp, r_flat)
        if ratio >= out["new_ratio"]:
            out.update(new_ratio=ratio, new_leaf=key)
        out["new_err"] = max(out["new_err"], diff.max().item() if diff.numel() else 0.0)
        del g_ref, p_ref, diff, sharp
    out["ok"] = out["grad_ratio"] <= 1.0 and out["new_ratio"] <= 1.0
    return out


_REFERENCES: dict = {}


def _self_reference(cfg, run: dict, dev) -> dict:
    """The unsharded record of ``run``'s model and batches, trained on this
    rank's device (every rank alike, at once: ranks sharing a card each
    hold a whole model then), kept for the next run of the same key (one
    at a time: a new key frees the last)."""
    from repro_torch.models import transformer as tr

    key = (cfg, run["batch"], run["seq"], run["steps"], run.get("lr", 1e-3),
           bool(run.get("grads_only")))
    if key not in _REFERENCES:
        _REFERENCES.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        params = tr.init_model(cfg, 0, device=dev)
        batches = train_batches(cfg, run["batch"], run["seq"], run["steps"])
        t0 = time.perf_counter()
        rec = train_record(cfg, params, batches, dev, lr=run.get("lr", 1e-3),
                           grads_only=bool(run.get("grads_only")))
        rec["wall_s"] = time.perf_counter() - t0
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _REFERENCES[key] = rec
    return _REFERENCES[key]


_KEPT: dict = {}


def check_train(mesh, dev, run: dict, index: int) -> dict:
    """One training run of the plan on this rank (module docstring)."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import specs
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models import transformer as tr
    from repro_torch.optim import AdamW
    from repro_torch.optim.tree import leaves
    from repro_torch.parallel import collectives as coll

    cfg = lm_config(run["arch"], layers=run.get("layers"), reduced=run.get("reduced", False))
    if run.get("kind") == "train_loop":
        return _check_train_loop(cfg, mesh, dev, run)
    lr = run.get("lr", 1e-3)
    want = None
    if run.get("record"):
        want = torch.load(run["record"])
    elif run.get("reference") == "self":
        want = _self_reference(cfg, run, dev)
    layout = specs.train_layout(cfg, mesh, run.get("layout", "tp"))
    _sync(dev)
    t0 = time.perf_counter()
    params = tr.init_model(cfg, 0, device=dev, mesh=mesh)
    if layout.name == "fsdp":
        params = tr.data_blocks(params, layout.params)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    opt = AdamW(lr=lr)
    state = init_opt_state(opt, params, layout)
    step = make_train_step(cfg, opt, remat=run.get("remat", "none"), mesh=mesh, shardings=layout)
    _sync(dev)
    build_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    out = {"arch": run["arch"], "layers": cfg.num_layers, "mesh": list(mesh.sizes),
           "coordinate": list(mesh.coordinate), "layout": layout.name,
           "remat": run.get("remat", "none"), "build_s": build_s, "losses": [], "step_s": [],
           "counts": [], "params_local": sum(t.numel() for t in leaves(params))}
    peak0 = 0.0
    for i, b in enumerate(train_batches(cfg, run["batch"], run["seq"], run["steps"])):
        seen = {} if i == 0 else None
        coll.reset()
        _sync(dev)
        t1 = time.perf_counter()
        params, state, m = step(params, state, b, record=seen)
        _sync(dev)
        out["step_s"].append(time.perf_counter() - t1)
        out["counts"].append(coll.counts())
        if i == 0:
            books = _books()
        out["losses"].append(float(m["loss"]))
        if i == 0:  # held before the next step writes the shard in place
            if dev.type == "cuda":
                peak0 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            clip = m["clip_scale"].detach().float().cpu().reshape(1)
            out.update(loss=float(m["loss"]), ce=float(m["ce"]), aux=float(m["moe_aux"]),
                       clip_scale=float(clip), clip_bits=int(clip.view(torch.int32)))
            first = {"grads": {k: g.detach() for k, g in flat_tree(seen["grads"]).items()},
                     "new": {k: p.detach() for k, p in flat_tree(params).items()}}
            del seen
            if want is not None:
                out["hold"] = hold_train_step(first, want, flat_tree(layout.params), dev, lr)
            same = run.get("same_bits_as")
            if same is not None:  # the kept blocks sit on the host, off the peak
                kept = _KEPT.pop(same)
                out["same_bits"] = all(torch.equal(first[part][k].cpu(), kept[part][k])
                                       for part in ("grads", "new") for k in kept[part])
                out["same_bits_peak_gib"] = kept.get("peak_gib")
            if run.get("keep"):
                _KEPT[index] = {part: {k: v.to("cpu", copy=True) for k, v in first[part].items()}
                                for part in ("grads", "new")}
            del first
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
    if dev.type == "cuda":
        out["peak_gib"] = max(peak0, torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        if run.get("keep"):
            _KEPT[index]["peak_gib"] = out["peak_gib"]
    out["kernel_launches"] = {k: v for k, v in _counters().items() if k in ("K3", "K7")}
    meta = meta_books(cfg, mesh, InputShape("train", run["seq"], run["batch"], "train"),
                      fsdp=layout.name == "fsdp", zero1=layout.name == "zero1",
                      remat=run.get("remat", "none"))
    out.update(meta_equal=meta["books"] == books, meta_s=meta["seconds"], ops=books["ops"])
    if want is not None:
        out["loss_rel"] = [abs(a - b) / abs(b) for a, b in zip(out["losses"], want["losses"])]
        out["first"] = {"ce_err": abs(out["ce"] - want["ce"]),
                        "aux_err": abs(out["aux"] - want["aux"]),
                        "clip_err": abs(out["clip_scale"] - want.get("clip_scale",
                                                                     out["clip_scale"]))}
        out["reference_step_s"] = want["step_s"]
        out["reference_peak_gib"] = want.get("peak_gib")
        out["reference_wall_s"] = want.get("wall_s")
    del params, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _check_train_loop(cfg, mesh, dev, run: dict) -> dict:
    """``train_loop`` unsharded, then under ``mesh``: every loss and the
    rank's final shard against the unsharded run's (bitwise, and the max
    abs error)."""
    from repro_torch.launch.train import train_loop
    from repro_torch.models import transformer as tr
    from repro_torch.parallel.sharding import tree_map_with_path

    kw = dict(steps=run["steps"], batch=run["batch"], seq=run["seq"], lr=run.get("lr", 3e-4),
              log_every=run["steps"])
    t0 = time.perf_counter()
    plain_times: list = []
    whole, want = train_loop(cfg, device=dev, step_times=plain_times, **kw)
    plain_s = time.perf_counter() - t0
    shards = flat_tree(tr.model_shardings(cfg, mesh))
    blocks = tree_map_with_path(
        lambda path, t: shards["/".join(path)].local(t.detach()).clone(), whole)
    del whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    times: list = []
    got, losses = train_loop(cfg, mesh=mesh, step_times=times, **kw)
    mesh_s = time.perf_counter() - t0
    a, b = flat_tree(got), flat_tree(blocks)
    out = {"arch": run["arch"], "layers": cfg.num_layers, "mesh": list(mesh.sizes),
           "coordinate": list(mesh.coordinate), "kind": "train_loop", "losses": losses,
           "plain_losses": want, "losses_bitwise": losses == want,
           "params_bitwise": all(torch.equal(a[k].detach(), b[k]) for k in b),
           "max_abs_err": max((a[k].detach() - b[k]).abs().max().item() for k in b),
           "plain_s": plain_s, "mesh_s": mesh_s, "step_s": times, "plain_step_s": plain_times}
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del got, blocks, a, b
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _train_rank_main(rank: int, world: int, port: int, out_dir: str, opts: dict) -> None:
    from repro_torch.parallel import init_mesh

    dev = init_rank(rank, world, port, opts["device"], opts["backend"])
    try:
        res = []
        for i, run in enumerate(opts["plan"]):
            t0 = time.perf_counter()
            mesh = init_mesh(*run["mesh"], device=dev)
            res.append(dict(check_train(mesh, dev, run, i), run_s=time.perf_counter() - t0))
        put_result(out_dir, rank, res)
    finally:
        dist.destroy_process_group()


def run_train(world: int, plan: list, *, device: str = "cuda",
              backend: str | None = None) -> dict:
    """Spawn ``world`` ranks and run the training ``plan``; returns every
    run's per-rank results, the cross-rank checks and ``ok``: against a
    record, every gradient and new block within bound, every step's loss
    within ``TRAIN_LOSS_RTOL``, the first step's ce and aux within 1e-6
    (ce relative above 1) and clip scale within 1e-6; every rank's losses
    and clip scale the same bits; ``same_bits_as`` bitwise with a lower
    peak on the card; a ``train_loop`` run bitwise at world 1."""
    backend = backend or default_backend(device, world)
    for run in plan:
        run.setdefault("mesh", [1, world])
        if run["mesh"][0] * run["mesh"][1] != world:
            raise ValueError(f"mesh {run['mesh']} does not cover {world} ranks")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu")
    t0 = time.perf_counter()
    ranks = spawn_ranks(_train_rank_main, world, dict(device=device, backend=backend, plan=plan))
    runs, ok = [], True
    for i, run in enumerate(plan):
        per = [r[i] for r in ranks]
        rec = {k: v for k, v in per[0].items() if k not in ("coordinate",)}
        rec["ranks"] = per
        agree = all(p["losses"] == per[0]["losses"] for p in per)
        if run.get("kind") == "train_loop":
            good = agree and (world > 1 or (per[0]["losses_bitwise"]
                                            and all(p["params_bitwise"] for p in per)))
        else:
            agree &= all(p["clip_bits"] == per[0]["clip_bits"] for p in per)
            # training runs the plain attention and SSD (no kernel has a backward);
            # every rank's meta count equals its first step's books
            good = agree and all(not any(p["kernel_launches"].values()) for p in per)
            good &= all(p["meta_equal"] for p in per)
            if "hold" in per[0]:
                good &= all(p["hold"]["ok"] and max(p["loss_rel"]) <= TRAIN_LOSS_RTOL
                            and p["first"]["ce_err"] <= 1e-6 * max(1.0, abs(p["ce"]))
                            and p["first"]["aux_err"] <= 1e-6
                            and p["first"]["clip_err"] <= 1e-6 for p in per)
            if run.get("same_bits_as") is not None:
                good &= all(p["same_bits"] for p in per)
                if device == "cuda":
                    good &= all(p["peak_gib"] < p["same_bits_peak_gib"] for p in per)
        rec["ranks_agree"] = bool(agree)
        rec["ok"] = bool(good)
        ok &= bool(good)
        runs.append(rec)
    return {"world": world, "device": device, "backend": backend,
            "seconds": time.perf_counter() - t0, "train": runs, "ok": bool(ok)}


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
            res["pipeline"] = check_pipeline(dev, opts["arch"], world)
            res["tensor_parallel"] = check_tensor_parallel(mesh2d, dev, opts["arch"])
            res["graphed"] = check_graphed(mesh1d, dev, opts["arch"])
        if dev.type == "cuda":
            res["all_reduce_9"] = time_all_reduce(dev)
        put_result(out_dir, rank, res)
    finally:
        dist.destroy_process_group()


def _gate_dit_mesh(results: dict, ranks: list, world: int, device: str) -> bool:
    """Checks 7, 8 and 9 into ``results`` (every rank's), and whether they
    passed: on the card also K3 (and in the solves K4) launched, K3 once a
    layer a microbatch a stage and once a layer in the TP forward."""
    pipe = [r["pipeline"] for r in ranks]
    tp = [r["tensor_parallel"] for r in ranks]
    results["pipeline"], results["tensor_parallel"] = pipe, tp
    ok = all(p["bitwise_equal"] for p in pipe)
    ok &= all(p["handoffs"][0] == (PIPE_MICROBATCHES if p["stage"] < world - 1 else 0)
              for p in pipe)
    if world == 1:
        for sol in (pipe[0]["solve"], tp[0]["solve"]):
            ok &= (sol["finite"] and sol["converged"] == PIPE_BATCH
                   and sol["max_nfe_diff"] <= NFE_SLACK and sol["graphed_ok"])
        ok &= all(p["bitwise_equal"] for p in tp)
    ok &= all(p["within_bound"] and p["meta_equal"] for p in tp)
    if device == "cuda":
        for p in pipe:
            ok &= p["k3_launches"] == (p["layers"][1] - p["layers"][0]) * PIPE_MICROBATCHES
        for p in tp:
            ok &= p["k3_launches"] == p["layers"]
        if world == 1:
            for sol in (pipe[0]["solve"], tp[0]["solve"]):
                ok &= sol["k4_launches"] > 0 and sol["k3_launches"] > 0
    graphed = [r["graphed"] for r in ranks]
    results["graphed"] = graphed
    ok &= all(g[m]["ok"] for g in graphed for m in g
              if isinstance(g[m], dict) and "ok" in g[m])
    return bool(ok)


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
    if arch:
        ok &= _gate_dit_mesh(results, ranks, world, device)
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
    ap.add_argument("--lm-arch", default=None,
                    help="check this LM under --mesh instead of the sampling checks")
    ap.add_argument("--lm-reduced", action="store_true", help="the scaled-down config")
    ap.add_argument("--mesh", default=None, help="D,M (default 1,world)")
    ap.add_argument("--flash-decode", action="store_true",
                    help="decode with decode_flash_shard='model'")
    ap.add_argument("--lm-prefill", default="1,64", help="prefill B,S")
    ap.add_argument("--lm-decode", default="4,8", help="decode B,STEPS")
    ap.add_argument("--lm-record", default=None, help="the unsharded record to compare with")
    ap.add_argument("--lm-out", default=None, help="write rank 0's record here")
    ap.add_argument("--lm-plan", default=None, help="a JSON list of LM runs")
    ap.add_argument("--train-plan", default=None,
                    help="a JSON list of LM training runs under a mesh")
    args = ap.parse_args(argv)
    backend = args.backend or default_backend(args.device, args.world)
    ints = lambda s: [int(v) for v in s.split(",")]
    try:
        if args.train_plan:
            with open(args.train_plan) as f:
                results = run_train(args.world, json.load(f), device=args.device,
                                    backend=backend)
        elif args.lm_plan or args.lm_arch:
            if args.lm_plan:
                with open(args.lm_plan) as f:
                    plan = json.load(f)
            else:
                plan = [dict(arch=args.lm_arch, reduced=args.lm_reduced,
                             mesh=ints(args.mesh) if args.mesh else [1, args.world],
                             flash_decode=args.flash_decode, prefill=ints(args.lm_prefill),
                             decode=ints(args.lm_decode), record=args.lm_record,
                             out=args.lm_out)]
            results = run_lm(args.world, plan, device=args.device, backend=backend)
        else:
            results = run(args.world, device=args.device, backend=backend, arch=args.arch)
    except Exception as e:  # a rank raised: report it on the JSON line, exit 1
        print(json.dumps({"world": args.world, "device": args.device, "backend": backend,
                          "error": f"{type(e).__name__}: {e}", "ok": False}))
        return 1
    print(json.dumps(results))
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
