"""Serving launchers; port of ``repro/launch/serve.py``: batched
language-model decode, the continuous-batching diffusion server and the
receding-horizon planner as a service.

LM mode (``--arch``): ``serve_batch`` prefills a batch of prompts by
replaying them token by token through the serve step (exact and
state-consistent, as the reference does), then decodes greedily. It
runs every architecture of the reference (``configs.ARCH_IDS``): the
dense attention models olmo-1b, qwen1.5-0.5b, qwen3-14b and gemma3-12b
(global and sliding-window GQA over ring-buffer KV caches), mamba2-2.7b,
the mixture-of-experts models deepseek-moe-16b and granite-moe-3b-a800m,
jamba-v0.1-52b (Mamba2, attention, dense and expert MLPs),
llama-3.2-vision-90b (cross-attention over image embeddings, which the
CLI draws from the seed: the reference's stubbed vision tower) and
musicgen-medium (four codebooks: prompts (B, P, 4)).
``serving.ContinuousBatcher`` serves the one-codebook models without
Mamba2 or cross-attention layers (MoE ones too) request by request.

``--diffusion`` runs ``serving.DiffusionBatcher`` (DESIGN.md §4, §7):
seeded requests drain through a DiT score network (seeded weights, the
zero-init leaves livened) with the horizon-chunked solver, the fused
solver step and flash attention, K1 (K2 with ``--tier``) and K3 on the
card. ``--arch`` names a DiT preset (``configs.diffusion.ARCHS``); without
it the net is the reference's small one at ``--image-size``.
``--device-resident`` runs the device-resident serve loop (DESIGN.md §12):
on the card one CUDA graph a driver window (a WHILE node over the
captured sync horizon; CUDA 12.3 or later), on the CPU the plain driver.
``--plan`` runs the receding-horizon planner as a service (DESIGN.md
§10): closed-loop plan requests (the state pinned by horizon-axis
inpainting, ``--cfg-scale`` returns guidance) drain through the same
``DiffusionBatcher``; ``repro_torch.launch.plan`` is the launcher
underneath.

Under ``torchrun`` (``WORLD_SIZE`` set) ``--diffusion`` serves on a mesh,
as the reference always does (DESIGN.md §3): each rank initialises the
process group from torchrun's environment (NCCL on ``cuda``, each rank
on card ``LOCAL_RANK``; gloo on ``cpu``), builds a WORLD_SIZE × 1
``("data", "model")`` mesh and runs ``DiffusionBatcher(mesh=)``, its
slots split over the ranks; rank 0 prints the record, with
``refills_per_device`` and ``slots_per_device``. The reference's
``--fake-devices`` (forced host devices in one process) has no
counterpart: a rank is a process.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --batch 4 --prompt-len 16 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --diffusion --arch highres_dit \\
      --slots 8 --requests 16 --sync-horizon 4 --tier mixed [--device-resident]
  PYTHONPATH=src python -m repro_torch.launch.serve --diffusion --device cpu \\
      --slots 4 --requests 8 --tier mixed --telemetry 256 --trace-out trace.json
  PYTHONPATH=src python -m repro_torch.launch.serve --plan --device cpu --envs 6 --plan-steps 4
  PYTHONPATH=src torchrun --nproc-per-node 2 --master-addr localhost --master-port 29500 \
      -m repro_torch.launch.serve --diffusion --device cpu --slots 4 --requests 8 --tier mixed
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import pathlib
import time
import weakref
from typing import Callable

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.precision import PRESETS
from repro_torch.device import resolve_device
from repro_torch.core.solvers.adaptive import CAPTURE, HOST, REPLAY, agree_branch
from repro_torch.launch.steps import GraphedServeStep, make_serve_step
from repro_torch.models import init_decode_state, init_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim.tree import leaves

Tensor = torch.Tensor


def serve_batch(cfg: ModelConfig, params, prompts: Tensor, *, gen_len: int = 32,
                cache_len: int | None = None, cross_embeds: Tensor | None = None,
                device="cuda", mesh=None, stats: dict | None = None) -> Tensor:
    """prompts (B, P) int, or (B, P, K) with K codebooks → the generated
    tokens (B, gen_len) or (B, gen_len, K) int32: the first from the last
    prompt position, then greedy. The attention layers' caches hold
    ``cache_len`` tokens (default P + gen_len; a sliding-window layer's at
    most its window). ``cross_embeds`` (B, num_patches, vision_dim) feed
    every step's cross-attention layers.

    Calls keep their decode state and serve step across calls
    (``_pooled``): a pool of ``SERVE_POOL_SIZE`` entries, least recently
    used out first, keyed by (cfg, B, cache length, device, mesh, the
    parameters' leaves), each state reset in place before a call
    (``reset_decode_state_``: bitwise ``init_decode_state``'s values). On
    the card (under a mesh, an NCCL mesh) the step is a
    ``launch.steps.GraphedServeStep`` under the solvers' one-shot rule:
    a key's first call decodes with the eager step, its second captures
    the step once, later calls replay it. Under a mesh the ranks agree on
    that branch first (``adaptive.agree_branch``). ``stats`` (a dict)
    receives the call's ``captures``, ``build_s`` and ``graphed`` (the
    steps ran as graph replays). An entry holds each parameter leaf
    weakly and goes when one is collected: a model its caller dropped
    leaves nothing on the card, and no graph replays over freed weights.

    ``mesh``: a collective (every rank calls it with the same prompts);
    ``params`` is the rank's shard, the decode state is laid out by
    ``init_decode_state(mesh=)``, and every rank returns every row's
    tokens: the reference's ``serve_batch`` under an ambient mesh with
    parameters placed by ``param_shardings``, made explicit."""
    dev = resolve_device(device if mesh is None else mesh.device)
    B, P = prompts.shape[:2]
    entry, fresh = _pooled(cfg, params, B, cache_len or (P + gen_len), dev, mesh)
    if not fresh:
        reset_decode_state_(entry.state)
    step = entry.step
    graphed = isinstance(step, GraphedServeStep)
    branch = HOST
    if graphed:
        branch = HOST if fresh else REPLAY if step.captures else CAPTURE
        if mesh is not None:
            branch = agree_branch(branch, mesh, dev)
        if branch == CAPTURE:
            step.reset()  # a rank that holds a graph the mesh agreed not to replay
    captures, build_s = getattr(step, "captures", 0), getattr(step, "build_s", 0.0)
    toks = greedy_decode(step.eager if branch == HOST and graphed else step, params,
                         prompts.to(dev), entry.state, gen_len=gen_len,
                         cross_embeds=None if cross_embeds is None else cross_embeds.to(dev))
    if stats is not None:
        stats.update(captures=getattr(step, "captures", 0) - captures,
                     build_s=getattr(step, "build_s", 0.0) - build_s,
                     graphed=graphed and branch != HOST)
    return toks


#: decode states (and their serve steps) ``serve_batch`` keeps across calls
SERVE_POOL_SIZE = 4


@dataclasses.dataclass
class _PoolEntry:
    state: dict
    step: Callable
    #: weak references to the parameter leaves, whose callbacks drop the entry
    anchor: tuple = ()


_pool: "collections.OrderedDict[tuple, _PoolEntry]" = collections.OrderedDict()


def _pooled(cfg: ModelConfig, params, batch: int, cache_len: int, dev, mesh) -> tuple:
    """(``serve_batch``'s pool entry for these arguments, whether it was
    made now). A new entry holds a fresh ``init_decode_state`` and a
    ``make_serve_step``."""
    flat = leaves(params)
    key = (cfg, batch, int(cache_len), str(dev), None if mesh is None else mesh.key(),
           tuple(id(p) for p in flat))
    entry = _pool.get(key)
    if entry is not None:
        _pool.move_to_end(key)
        return entry, False
    entry = _PoolEntry(state=init_decode_state(cfg, batch, cache_len, device=dev, mesh=mesh),
                       step=make_serve_step(cfg, device=dev, mesh=mesh))
    entry.anchor = tuple(weakref.ref(p, lambda _, key=key: _pool and _pool.pop(key, None))
                         for p in flat)
    _pool[key] = entry
    while len(_pool) > SERVE_POOL_SIZE:
        _pool.popitem(last=False)
    return entry, True


def clear_serve_pool() -> None:
    """Drop every pooled decode state and serve step."""
    _pool.clear()


def state_tensors(state) -> list:
    """Every tensor of a decode state, in its order (the caches'
    dataclasses walked field by field; a ``sharding`` is no state)."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for v in state.values() for t in state_tensors(v)]
    if dataclasses.is_dataclass(state):
        return [t for f in dataclasses.fields(state) if f.name != "sharding"
                for t in state_tensors(getattr(state, f.name))]
    return []


def reset_decode_state_(state) -> None:
    """A used decode state back to ``init_decode_state``'s values, in place:
    every cache's ``pos`` to −1, every other tensor to 0 (a cache's
    ``sharding`` is left as it is)."""
    for name, v in (state.items() if isinstance(state, dict) else
                    ((f.name, getattr(state, f.name)) for f in dataclasses.fields(state))):
        if isinstance(v, torch.Tensor):
            v.fill_(-1 if name == "pos" else 0)
        elif isinstance(v, dict) or (dataclasses.is_dataclass(v) and name != "sharding"):
            reset_decode_state_(v)


def greedy_decode(step: Callable, params, prompts: Tensor, state, *, gen_len: int,
                  cross_embeds: Tensor | None = None) -> Tensor:
    """``serve_batch``'s loop on a given serve step and decode state (both
    on the prompts' device): the prompts replayed token by token (exact
    and state-consistent, as the reference does; the fused prefill is
    ``make_prefill_step``), then ``gen_len`` − 1 greedy steps. The state
    is written in place; returns the generated tokens."""
    extra = {} if cross_embeds is None else {"cross_embeds": cross_embeds}
    next_tok = None
    for i in range(prompts.shape[1]):
        next_tok, state = step(params, {"tokens": prompts[:, i:i + 1], **extra}, state)

    out = [next_tok]
    for _ in range(gen_len - 1):
        nt, state = step(params, {"tokens": out[-1], **extra}, state)
        out.append(nt)
    return torch.cat(out, dim=1)


def serve_diffusion(*, slots: int, requests: int, image_size: int = 8,
                    arch: str | None = None, sync_horizon: int = 4,
                    compaction: bool = True, precision: str = "fp32",
                    inpaint: bool = False, cfg_scale: float | None = None,
                    device_resident: bool = False, tier: str | None = None,
                    deadline_ms: float | None = None, telemetry: int = 0,
                    metrics_out: str | None = None, trace_out: str | None = None,
                    device="cuda", mesh=None, uids=None) -> dict:
    """Continuous-batching diffusion serving on ``device``; returns (and
    prints) the reference's record: throughput, mean NFE, the wasted-NFE
    fraction, host transfers, per-class stats.

    ``requests`` seeded requests (seed = uid) drain through the slot
    batch with ``sync_horizon`` iterations a host sync (DESIGN.md §7).
    ``inpaint`` gives every request a checkerboard mask (phase by uid);
    ``cfg_scale`` a class-conditional DiT with classifier-free guidance,
    labels cycling by uid (DESIGN.md §9). ``tier`` is a tolerance class
    every request rides, or ``"mixed"`` to cycle the presets; a tiered
    server admits EDF within priority bands (DESIGN.md §14).
    ``telemetry`` is the ring's capacity a slot; ``metrics_out`` writes
    the registry as JSON and a sibling ``.prom``; ``trace_out`` turns the
    stage tracer on and writes ``trace_record()`` as JSON (DESIGN.md §15).
    ``device_resident=True`` serves through the device-resident driver
    (DESIGN.md §12); the record then counts its windows. ``mesh`` serves
    data-parallel (``DiffusionBatcher(mesh=)``, a collective: every rank
    calls this with the same arguments); the record is the same on every
    rank, the files are written and the summary printed by rank 0 only.
    ``uids`` names the requests served (default ``range(requests)``): a
    request's seed and payload follow its uid whatever it is served with,
    so ``uids=[u]`` is u's solo run. The record's ``delivered`` holds the
    delivered ``ImageRequest``s by uid (samples, payloads, NFE), which the
    reference's record does not.
    """
    from repro_torch.configs.diffusion import ARCHS
    from repro_torch.core.guidance import ClassifierFree, Inpaint
    from repro_torch.core.precision import resolve_policy
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.models.dit import DiTConfig, init_dit, liven_zero_init
    from repro_torch.observability.tracing import StageTracer
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest
    from repro_torch.serving.scheduler import EdfPriorityAdmission

    if inpaint and cfg_scale is not None:
        raise ValueError("pick one conditioner per server: --inpaint or --cfg-scale")
    dev = resolve_device(device if mesh is None else mesh.device)
    lead = mesh is None or all(c == 0 for c in mesh.coordinate)
    num_classes = 10 if cfg_scale is not None else 0
    if arch is None:
        net = DiTConfig(image_size=image_size, patch=4, d_model=32, num_layers=2,
                        num_heads=2, d_ff=64)
    else:
        net = ARCHS[arch]
    net = dataclasses.replace(net, num_classes=num_classes, use_flash=True)
    image_size = net.image_size
    sde = VPSDE()
    policy = resolve_policy(precision)
    conditioner = None
    if inpaint:
        conditioner = Inpaint()
    elif cfg_scale is not None:
        conditioner = ClassifierFree(scale=float(cfg_scale))
    cfg = AdaptiveConfig(eps_rel=0.05, precision=precision, conditioner=conditioner,
                         use_fused_kernel=True)
    # weights from seed 0, the zero-init leaves livened (a fresh DiT
    # returns exactly 0), stored at the policy's param dtype
    model = init_dit(net, torch.Generator(device=dev).manual_seed(0))
    liven_zero_init(model, torch.Generator(device=dev).manual_seed(0))
    policy.cast_params(model)
    step = make_sample_step(sde, cfg)
    shape = (image_size, image_size, net.channels)
    tiered = tier is not None
    if tiered and tier != "mixed":
        from repro_torch.configs.diffusion import resolve_tier
        resolve_tier(tier)  # fail fast on a bad preset name
    tracer = StageTracer() if trace_out else None
    b = DiffusionBatcher(sde, step, model, shape, slots=slots, cfg=cfg,
                         sync_horizon=sync_horizon, compaction=compaction,
                         device_resident=device_resident,
                         tolerance_classes=tiered or None,
                         admission=EdfPriorityAdmission(aging_s=5.0) if tiered else None,
                         telemetry=telemetry, tracer=tracer, device=dev, mesh=mesh)
    mixed_cycle = ("draft", "standard", "high_fidelity")

    def request_tier(uid: int):
        if not tiered:
            return None
        return mixed_cycle[uid % len(mixed_cycle)] if tier == "mixed" else tier

    def request_cond(uid: int):
        if inpaint:
            yy, xx = torch.meshgrid(torch.arange(image_size), torch.arange(image_size),
                                    indexing="ij")
            mask = ((yy // 2 + xx // 2) + uid) % 2 == 0
            mask = mask[:, :, None].expand(shape).to(torch.float32)
            observed = torch.linspace(-0.5, 0.5, image_size)[:, None, None].expand(shape)
            return {"mask": mask, "observed": observed.to(torch.float32)}
        if cfg_scale is not None:
            return {"label": uid % num_classes}
        return None

    uids = range(requests) if uids is None else list(uids)
    for uid in uids:
        b.submit(ImageRequest(uid=uid, seed=uid, cond=request_cond(uid),
                              tier=request_tier(uid), deadline_ms=deadline_ms))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = b.run_to_completion()
    dt = time.perf_counter() - t0
    nfes = [done[u].nfe for u in sorted(done)]
    rec = {
        "devices": b.n_devices,
        "slots": slots,
        "slots_per_device": b.slots_per_device,
        "sync_horizon": sync_horizon,
        "compaction": compaction,
        "precision": policy.as_dict(),
        "conditioner": ("inpaint" if inpaint
                        else f"cfg:{cfg_scale}" if cfg_scale is not None else "none"),
        "completed": len(done),
        "samples_per_sec": len(done) / dt,
        "mean_nfe": sum(nfes) / len(nfes),
        "total_iterations": b.total_iterations,
        "wasted_nfe_fraction": b.wasted_nfe_fraction,
        "refills_per_device": list(b.refills_per_device),
        "device_resident": device_resident,
        "host_transfers": b.host_transfers,
        "host_transfers_per_request": b.host_transfers / max(len(done), 1),
        "horizon_windows": b.horizon_windows,
        "tier": tier,
        "deadline_ms": deadline_ms,
        "class_stats": b.class_stats if tiered else None,
        "telemetry": telemetry,
        "metrics_out": metrics_out,
        "trace_out": trace_out,
        # the port's own: the device, the net, the solver's syncs apart
        # from the serve loop's reads, the wall time
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "arch": arch,
        "solver_syncs": b.solver_syncs,
        "passenger_nfe_fraction": b.passenger_nfe_fraction,
        "wall_s": dt,
        "delivered": done,
    }
    trace = b.trace_record() if trace_out else None  # a collective under a mesh
    if not lead:
        return rec
    if metrics_out:
        reg = b.metrics_snapshot()
        path = pathlib.Path(metrics_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(reg.to_json(), indent=2) + "\n")
        path.with_suffix(".prom").write_text(reg.to_prometheus())
        print(f"metrics -> {path} (+ {path.with_suffix('.prom').name})")
    if trace_out:
        path = pathlib.Path(trace_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(trace, indent=2) + "\n")
        print(f"trace -> {path}")
    print(f"diffusion serve[{policy.name}, {rec['conditioner']}] on {rec['device']}"
          f"{f' × {b.n_devices} ranks' if mesh is not None else ''}: "
          f"{rec['completed']}/{len(uids)} requests in {dt:.2f} s "
          f"({rec['samples_per_sec']:.2f} samples/s), {slots} slots, horizon "
          f"{sync_horizon}, mean NFE {rec['mean_nfe']:.1f}, wasted NFE "
          f"{rec['wasted_nfe_fraction']:.1%}, host transfers/request "
          f"{rec['host_transfers_per_request']:.1f}, solver syncs {b.solver_syncs}, "
          f"{'driver windows' if device_resident else 'chunks'} {b.horizon_windows}")
    if tiered:
        for name in sorted(rec["class_stats"]):
            st = rec["class_stats"][name]
            print(f"  tier {name:>13}: {st['delivered']} delivered, mean NFE "
                  f"{st['mean_nfe']:.1f}, deadline misses {st['deadline_misses']}, "
                  f"mean wait {st['mean_wait_s'] * 1e3:.0f} ms")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help=f"LM mode: one of {list(ARCH_IDS)}; --diffusion: a DiT "
                         "preset of configs.diffusion.ARCHS (default: the "
                         "reference's small net at --image-size)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's scaled_down() variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--diffusion", action="store_true",
                    help="run the continuous-batching diffusion server instead")
    ap.add_argument("--plan", action="store_true",
                    help="run the receding-horizon planner service (DESIGN.md §10)")
    ap.add_argument("--plan-env", default="ou", choices=["ou", "pointmass"],
                    help="analytic environment for --plan")
    ap.add_argument("--envs", type=int, default=6,
                    help="closed-loop environments for --plan")
    ap.add_argument("--plan-steps", type=int, default=4,
                    help="control rounds per environment for --plan")
    ap.add_argument("--plan-horizon", type=int, default=8, help="plan horizon H for --plan")
    ap.add_argument("--unet", action="store_true",
                    help="--plan with a temporal UNet score instead of the analytic one")
    ap.add_argument("--image-size", type=int, default=8,
                    help="--diffusion without --arch: the small net's image size")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--sync-horizon", type=int, default=4,
                    help="device iterations per host sync (diffusion mode)")
    ap.add_argument("--no-compaction", action="store_true",
                    help="monolithic-wave baseline: no mid-flight slot refill")
    ap.add_argument("--device-resident", action="store_true",
                    help="device-resident serve loop: one host read a driver window "
                         "(DESIGN.md §12; CUDA graphs on the card)")
    ap.add_argument("--precision", default="fp32", choices=sorted(PRESETS),
                    help="precision policy of the diffusion server (DESIGN.md §8)")
    ap.add_argument("--inpaint", action="store_true",
                    help="per-request checkerboard-mask inpainting (DESIGN.md §9)")
    ap.add_argument("--cfg-scale", type=float, default=None,
                    help="per-request classifier-free guidance at this scale")
    ap.add_argument("--tier", default=None,
                    help="tolerance class of every request (draft/standard/"
                         "high_fidelity) or 'mixed' to cycle them (DESIGN.md §14)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget; late deliveries count as misses")
    ap.add_argument("--telemetry", type=int, default=0,
                    help="per-slot step-telemetry ring capacity; 0 = off (DESIGN.md §15)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry as JSON here plus a sibling .prom")
    ap.add_argument("--trace-out", default=None,
                    help="turn stage tracing on and write the trace record here; "
                         "'python -m repro_torch.analysis.telemetry' renders it")
    args = ap.parse_args(argv)

    if args.plan:
        from repro_torch.launch.plan import serve_planning

        return serve_planning(
            env_name=args.plan_env, envs=args.envs, steps=args.plan_steps,
            slots=args.slots, sync_horizon=args.sync_horizon,
            compaction=not args.no_compaction, horizon=args.plan_horizon,
            cfg_scale=args.cfg_scale or 0.0, precision=args.precision, unet=args.unet,
            device=args.device)
    if args.diffusion:
        mesh = None
        if "WORLD_SIZE" in os.environ:
            from repro_torch.launch.sample import torchrun_mesh

            mesh = torchrun_mesh(args.device)
        try:
            return serve_diffusion(
                slots=args.slots, requests=args.requests, image_size=args.image_size,
                arch=args.arch, sync_horizon=args.sync_horizon,
                compaction=not args.no_compaction, precision=args.precision,
                inpaint=args.inpaint, cfg_scale=args.cfg_scale,
                device_resident=args.device_resident, tier=args.tier,
                deadline_ms=args.deadline_ms, telemetry=args.telemetry,
                metrics_out=args.metrics_out, trace_out=args.trace_out,
                device=args.device, mesh=mesh)
        finally:
            if mesh is not None:
                torch.distributed.destroy_process_group()
    if args.arch is None:
        ap.error("--arch is required unless --diffusion or --plan is given")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.scaled_down()
    # weights, prompts and image embeddings from seed 0
    params = init_model(cfg, 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (args.batch, args.prompt_len)
    if cfg.num_codebooks > 1:
        shape += (cfg.num_codebooks,)
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)
    cross = None
    if cfg.vision_dim:
        cross = torch.randn((args.batch, cfg.num_patches, cfg.vision_dim), generator=g,
                            device=dev).to(getattr(torch, cfg.dtype))
    stats = {}
    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, prompts, gen_len=args.gen_len, cross_embeds=cross,
                       device=dev, stats=stats)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_steps = args.prompt_len + args.gen_len - 1
    rec = {"arch": cfg.name, "device": str(dev), "batch": args.batch,
           "prompt_len": args.prompt_len, "gen_len": args.gen_len,
           "wall_s": dt, "ms_per_step": dt / n_steps * 1e3,
           "tokens_per_s": args.batch * args.gen_len / dt,
           "graph_captures": stats["captures"], "graph_build_s": stats["build_s"],
           "tokens": toks.tolist()}
    print(f"{cfg.name} on {dev}: generated {tuple(toks.shape)} in {dt:.2f} s "
          f"({rec['ms_per_step']:.1f} ms per step of {args.batch}, "
          f"{rec['tokens_per_s']:.1f} new tokens/s; {stats['captures']} CUDA graph "
          f"captured in {stats['build_s']:.3f} s)")
    print("sample:", toks[0, :16].tolist())
    return rec


if __name__ == "__main__":
    main()
