"""Demo sampling launcher; port of the run and dry-run modes of
``repro/launch/sample.py`` and of its ``make_sample_step``, the serving
loop's device step.

Samples a batch from a DiT score network made from a seed on the VP SDE,
first with the adaptive solver and then with Euler–Maruyama at 100
steps, as the reference's demo does, and prints for each the NFE,
iterations, the converged count, wall time and the kernels' launch
counts:

  PYTHONPATH=src python -m repro_torch.launch.sample --arch highres_dit --fused --flash

``--cfg-scale S`` and ``--inpaint`` are the reference's controlled
generation demos (``demo_cfg``, ``demo_inpaint``; DESIGN.md §9), one
adaptive solve each of the ``--arch`` DiT: classifier-free guidance at
scale S on the net made class-conditional (``DEMO_CLASSES`` classes,
labels cycling 0..9; one forward over 2B rows an evaluation), or
inpainting of the reference's checkerboard (``checkerboard``: observed
pixels projected after every accepted step, pinned exactly at delivery).
``--cfg-scale`` wins over ``--inpaint``, as in the reference. Their
record adds the conditioner, the observed-pixel residual and P1's
launches (inpainting draws twice an iteration). They run on one device,
as the reference's demos do: under ``torchrun`` they are refused.
``demo_cfg`` and ``demo_inpaint`` run them on the reference demos' 16 px,
2-layer net (``DEMO_DIT``).

  PYTHONPATH=src python -m repro_torch.launch.sample --arch highres_dit --fused --flash --cfg-scale 1.5
  PYTHONPATH=src python -m repro_torch.launch.sample --device cpu --inpaint

On the card every solver can run as one captured CUDA graph
(``core.solvers.adaptive.cached_driver``), but a key's first solve runs
the host-driven chain (the one-shot rule): the launcher solves once a
key (each run builds its own score network), so it never captures and
pays no capture in its wall.

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
weight and state bytes they imply (``_precision_record``). On one card
by default; ``--mesh 1pod`` and ``--multi-pod`` (``2pod``) count one
rank of the reference's (16, 16) and (2, 16, 16) production meshes
(``launch/mesh.py::make_production_mesh``): its rows of the state over
the data axes, its blocks of the weights under the DiT's
tensor-parallel rules (``_dit_param_shardings``), and the collectives it
would call, by the reference's op kinds, inside
``parallel.collectives.counting()``. ``--pipeline`` (2pod only, as in
the reference) runs the forward as GPipe stages over "pod" at 4
microbatches (``make_pipelined_dit_forward``). Every layer runs, so the
counts are about an order of magnitude above the reference's, whose
``cost_analysis`` counts the scanned layer body once. ``--dryrun-loop``
counts the whole sharded loop of CIFAR_DIT on a ``("data",)`` mesh of
``--loop-devices`` ranks (``dryrun_loop``). The records go to ``--out``
(default ``experiments/dryrun_torch/``).

  PYTHONPATH=src python -m repro_torch.launch.sample --dryrun --precision bf16_full
  PYTHONPATH=src python -m repro_torch.launch.sample --dryrun --multi-pod --pipeline
  PYTHONPATH=src python -m repro_torch.launch.sample --dryrun-loop --loop-devices 8 --batch 32
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import inspect
import json
import os
import time
from typing import Optional

import torch

from repro_torch.configs.diffusion import ARCHS
from repro_torch.core.guidance import class_conditional, inpaint as make_inpaint
from repro_torch.core.precision import PRESETS, resolve_policy
from repro_torch.core.sampling import gather_result, sample
from repro_torch.core.sde import VESDE, VPSDE, bcast
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers.adaptive import (
    ADAPTIVE_FAMILY, AdaptiveConfig, capture_horizon, solve_chunk,
)
from repro_torch.core.solvers.predictor_corrector import linspace_f32
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.philox import ops as philox_ops
from repro_torch.kernels.solver_step import ops as step_ops
from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR, count
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.dit import (
    DiT, DiTConfig, dit_forward, dit_param_shapes, init_dit, liven_zero_init, make_score_fn,
    param_count,
)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.pipeline import pipeline_forward, stage_layers
from repro_torch.parallel.sharding import ParamSharding, batch_sharding, tree_map_with_path


#: the dry run's meshes: one card, the reference's one- and two-pod meshes
DRYRUN_MESHES = ("1card", "1pod", "2pod")
#: the pipelined forward's microbatches in the dry run (the reference's default)
PIPELINE_MICROBATCHES = 4
#: the reference demos' network (``demo``, ``demo_cfg``, ``demo_inpaint``): 16 px, 2 layers
DEMO_DIT = DiTConfig(image_size=16, patch=4, d_model=96, num_layers=2, num_heads=4, d_ff=256)
#: the classes of the class-conditional net of ``--cfg-scale`` (the reference's 10)
DEMO_CLASSES = 10


def _dit_param_shardings(model, mesh: Mesh, pipeline_axis: Optional[str] = None):
    """The DiT's tensor-parallel rules (reference :68-101): a tree of
    ``ParamSharding`` over ``models/dit.py::dit_param_shapes`` of
    ``model`` (a ``DiT`` or its ``DiTConfig``), on the stacked shapes:
    ``wq``/``wk``/``wv`` on their heads and ``wo`` on its heads where n
    divides them, ``w_in``/``w_gate`` on F and ``w_out`` on F, the 3-D
    ``ada`` on its 6E columns, each where the size n of "model" divides
    the dimension; with ``pipeline_axis``, every ``layers`` leaf also cut
    on its repeat axis (GPipe stages) where that axis divides it; every
    other leaf replicated."""
    cfg = model if isinstance(model, DiTConfig) else model.cfg
    msize = mesh.shape.get("model", 1)

    def fn(path, shape):
        name = "/".join(path)
        stage = pipeline_axis if (
            pipeline_axis and name.startswith("layers")
            and shape[0] % mesh.shape.get(pipeline_axis, 1) == 0) else None
        ok = lambda d: shape[d] % msize == 0
        if name.endswith(("attn/wq", "attn/wk", "attn/wv")) and ok(2):
            spec = (stage, None, "model", None)
        elif name.endswith("attn/wo") and ok(1):
            spec = (stage, "model", None, None)
        elif name.endswith(("mlp/w_in", "mlp/w_gate")) and ok(2):
            spec = (stage, None, "model")
        elif name.endswith("mlp/w_out") and ok(1):
            spec = (stage, "model", None)
        elif name.endswith("/ada") and len(shape) == 3 and ok(2):
            spec = (stage, None, "model")
        elif stage:
            spec = (stage,)
        else:
            spec = ()
        return ParamSharding(mesh, spec)

    return tree_map_with_path(fn, dit_param_shapes(cfg))


def seeded_dit(net: DiTConfig, *, seed: int, liven_seed: int, device) -> DiT:
    """A DiT of ``net`` on ``device``: weights drawn from ``seed``, the
    zero-init leaves livened from ``liven_seed`` unless it is negative."""
    dev = resolve_device(device)
    model = init_dit(net, torch.Generator(device=dev).manual_seed(seed))
    if liven_seed >= 0:
        liven_zero_init(model, torch.Generator(device=dev).manual_seed(liven_seed))
    return model


def build_score(arch: str, *, flash: bool, precision: str, seed: int,
                liven_seed: int, device) -> tuple:
    """(cfg, model, score_fn) for ``arch`` on ``device`` (``seeded_dit``)."""
    cfg = dataclasses.replace(ARCHS[arch], use_flash=flash)
    model = seeded_dit(cfg, seed=seed, liven_seed=liven_seed, device=device)
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


def make_pipelined_dit_forward(model: DiT, *, num_microbatches: int = 4, axis: str = "pod",
                               policy=None, mesh: Mesh, sharded_rows: bool = False):
    """The DiT forward with its blocks pipelined over ``axis`` (GPipe,
    ``parallel/pipeline.py``); port of the reference's (:152-209).

    Returns ``fwd(model, x, t)``, a ``make_sample_step`` forward (no
    label input, as in the reference), ``model`` the rank's DiT: its
    stage's blocks (``_dit_param_shardings(..., pipeline_axis=axis)``),
    each on its heads and F columns where the mesh has "model" (the
    tensor-parallel forward). The patch tokens and the fp32 timestep
    embedding from the stored weights come first; the embedding rides as
    one extra token, so one tensor crosses each stage boundary; the stage
    runs the rank's blocks, and every rank runs the final adaLN and the
    output projection on the pipeline's outputs. ``policy`` casts as the
    DiT's forward does.

    The pipeline takes the whole batch on every stage (the reference's
    ``in_specs=P()``). With ``sharded_rows`` x holds this rank's rows of a
    batch sharded over the data axes (the solver's carry): the rows of
    the ranks along ``axis`` are gathered first, and the rank keeps its
    block of the outputs. At one stage the result is bitwise the whole
    model's blocks run microbatch by microbatch.

    Raises ``ValueError`` unless ``model`` holds exactly its stage's
    layers (``pipeline.stage_layers``): when n does not divide the
    layers, the rules keep every block on every stage, and the pipeline
    would run the stack n times over.
    """
    n = mesh.shape[axis]
    want = stage_layers(model.cfg.num_layers, mesh, axis)
    if model.layer_range != want:
        raise ValueError(f"this DiT holds layers {model.layer_range}, not its stage's {want}")

    def fwd(params: DiT, x, t):
        h, temb, cw = params.embed(x, t, policy=policy)
        hm = torch.cat([h, temb[:, None, :]], dim=1)
        if sharded_rows:
            hm = coll.all_gather_dim(hm, 0, mesh, axis, backward="own")

        def stage(hm_mb):
            h_mb, temb_mb = hm_mb[:, :-1].contiguous(), hm_mb[:, -1].contiguous()
            h_mb = params.run_blocks(h_mb, temb_mb, cw, mesh)
            return torch.cat([h_mb, temb_mb[:, None, :]], dim=1)

        hm = pipeline_forward(stage, hm, mesh=mesh, axis=axis,
                              num_microbatches=num_microbatches)
        if sharded_rows and n > 1:
            b = hm.shape[0] // n
            hm = hm[mesh.coord(axis) * b:(mesh.coord(axis) + 1) * b]
        return params.head(hm[:, :-1].contiguous(), hm[:, -1].contiguous(), cw)

    return fwd


def run(arch: str = "cifar_dit", *, batch: int = 8, precision: str = "fp32",
        eps_rel: float = 0.05, max_iters: int = 100_000, flash: bool = False,
        fused: bool = False, seed: int = 0, liven_seed: int = 0,
        device="cuda", method: str = "adaptive", mesh=None,
        cfg_scale: Optional[float] = None, inpaint: bool = False,
        **solver_kwargs) -> dict:
    """One sample with ``method``; returns the record the launcher prints.

    ``eps_rel``, ``max_iters``, ``fused`` and ``precision`` configure the
    Algorithm-1 families (``ADAPTIVE_FAMILY``: ``adaptive``, ``momentum``,
    ``heun``); ``solver_kwargs`` go to the solver as they are (for
    example ``n_steps`` for the fixed-grid baselines). With ``mesh`` the
    solve is data-parallel (a collective: every rank calls ``run``); the
    wall time is this rank's, and the record describes the whole batch,
    gathered from every rank after the timed solve.

    ``cfg_scale`` (classifier-free guidance on the net made
    class-conditional) or ``inpaint`` (the reference's checkerboard) runs
    the controlled generation demo (``guidance``) on ``arch``: an
    Algorithm-1 family on one device only.
    """
    dev = resolve_device(device)
    net = dataclasses.replace(ARCHS[arch], use_flash=flash,
                              num_classes=DEMO_CLASSES if cfg_scale is not None else 0)
    model = seeded_dit(net, seed=seed, liven_seed=liven_seed, device=dev)
    return solve_record(model, arch, batch=batch, precision=precision, eps_rel=eps_rel,
                        max_iters=max_iters, fused=fused, seed=seed, device=dev,
                        method=method, mesh=mesh, cfg_scale=cfg_scale, inpaint=inpaint,
                        **solver_kwargs)


def checkerboard(batch: int, image_size: int, channels: int) -> tuple:
    """The reference demo's inpainting payload (``demo_inpaint``): the mask
    of the 4×4 squares whose block row and block column sum to an even
    number, over every channel and sample, and ``observed`` running from
    −0.5 to 0.5 down the rows (``jnp.linspace``'s points:
    ``linspace_f32``); both (batch, image_size, image_size, channels)
    fp32."""
    idx = torch.arange(image_size)
    yy, xx = torch.meshgrid(idx, idx, indexing="ij")
    shape = (batch, image_size, image_size, channels)
    mask = ((yy // 4 + xx // 4) % 2 == 0)[None, :, :, None].expand(shape)
    observed = linspace_f32(-0.5, 0.5, image_size)[None, :, None, None].expand(shape)
    return mask.to(torch.float32), observed.contiguous()


def guidance(batch: int, net: DiTConfig, *, cfg_scale: Optional[float] = None,
             inpaint: bool = False) -> tuple:
    """(conditioner, payload, name) of the launcher's controlled generation
    on ``batch`` samples of ``net``: classifier-free guidance at
    ``cfg_scale`` with labels ``arange(batch) % DEMO_CLASSES``
    (``class_conditional``), or inpainting of the ``checkerboard``
    (``inpaint``; one of the two), or (None, None, "none")."""
    if cfg_scale is not None and inpaint:
        raise ValueError("one conditioner a run: cfg_scale or inpaint")
    if cfg_scale is not None:
        return (*class_conditional(torch.arange(batch) % DEMO_CLASSES, cfg_scale),
                f"cfg:{float(cfg_scale)}")
    if inpaint:
        return (*make_inpaint(*checkerboard(batch, net.image_size, net.channels)), "inpaint")
    return None, None, "none"


def solve_record(model: DiT, arch: str, *, batch: int, precision: str, eps_rel: float,
                 max_iters: int, fused: bool, seed: int, device, method: str = "adaptive",
                 mesh=None, cfg_scale: Optional[float] = None, inpaint: bool = False,
                 prior=None, noise_fn=None, **solver_kwargs) -> dict:
    """``run``'s timed solve and record on ``model`` (``arch`` names it in
    the record). ``prior`` and ``noise_fn`` replace the per-row streams'
    prior and noise (the adaptive solve on the host-driven chain): the
    tests hand in the reference's own draws through them."""
    dev = resolve_device(device)
    cfg = model.cfg
    shape = (batch, cfg.image_size, cfg.image_size, cfg.channels)
    conditioner, cond, name = guidance(batch, cfg, cfg_scale=cfg_scale, inpaint=inpaint)
    if conditioner is not None and (method not in ADAPTIVE_FAMILY or mesh is not None):
        raise ValueError("controlled generation runs an Algorithm-1 family on one device "
                         f"(method {method!r}, mesh {mesh})")
    if method in ADAPTIVE_FAMILY:
        solver_kwargs = dict(eps_rel=eps_rel, max_iters=max_iters,
                             use_fused_kernel=fused, precision=precision,
                             **solver_kwargs)
    if conditioner is not None:
        solver_kwargs.update(conditioner=conditioner, cond=cond)
    score = make_score_fn(model, VPSDE(), policy=resolve_policy(precision))
    before = (step_ops.launches, step_ops.em_launches, flash_ops.launches,
              step_ops.sharded_launches, philox_ops.launches)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if prior is None and noise_fn is None:
        res = sample(VPSDE(), score, shape, seed=seed, device=dev, method=method,
                     mesh=mesh, **solver_kwargs)
    else:
        res = ad.adaptive(VPSDE(), score, prior, noise_fn=noise_fn, device=dev,
                          **solver_kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {"solver_step": step_ops.launches - before[0],
                "em_step": step_ops.em_launches - before[1],
                "flash_attention": flash_ops.launches - before[2],
                "sharded_solver_step": step_ops.sharded_launches - before[3]}
    if mesh is not None:
        res = gather_result(res, mesh, batch)
    rec = {
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
    if conditioner is not None:
        launches["philox_normal"] = philox_ops.launches - before[4]
        rec["conditioner"] = name
        rec["observed_residual"] = (None if "mask" not in cond else float(
            ((res.x - cond["observed"].to(dev)) * cond["mask"].to(dev)).abs().max()))
    return rec


def demo_cfg(scale: float, precision: str = "fp32", **kw) -> dict:
    """The reference's ``demo_cfg``: classifier-free guidance at ``scale``
    on ``DEMO_DIT`` made class-conditional (``DEMO_CLASSES`` classes,
    labels cycling 0..9), one adaptive solve of 8 samples at eps_rel 0.05;
    ``_demo``'s keywords."""
    return _demo(dataclasses.replace(DEMO_DIT, num_classes=DEMO_CLASSES), precision,
                 cfg_scale=scale, **kw)


def demo_inpaint(precision: str = "fp32", **kw) -> dict:
    """The reference's ``demo_inpaint``: the ``checkerboard`` inpainted on
    ``DEMO_DIT``, one adaptive solve of 8 samples at eps_rel 0.05; the
    record's ``observed_residual`` is exactly 0 (``finalize_project``)."""
    return _demo(DEMO_DIT, precision, inpaint=True, **kw)


def _demo(net: DiTConfig, precision: str, *, device="cuda", fused: bool = False,
          model: Optional[DiT] = None, prior=None, noise_fn=None, **guide) -> dict:
    """A guided demo's solve of 8 samples and its record (``solve_record``),
    printed: on ``model``, or on ``net`` made from seed 0 and livened
    (``seeded_dit``)."""
    if model is None:
        model = seeded_dit(net, seed=0, liven_seed=0, device=device)
    rec = solve_record(model, "demo_dit", batch=8, precision=precision, eps_rel=0.05,
                       max_iters=100_000, fused=fused, seed=0, device=device,
                       prior=prior, noise_fn=noise_fn, **guide)
    print(json.dumps({k: v for k, v in rec.items() if k != "result"}))
    return rec


def _precision_record(policy, param_bytes: int, state_x) -> dict:
    """The policy's dtypes and the bytes they imply (reference :214): the
    whole tree's stored weights, and x and x_prev of the carry on one
    device (``state_x``: this device's rows of the state)."""
    rec = policy.as_dict()
    rec["param_bytes_total"] = param_bytes
    rec["state_bytes_per_device"] = 2 * state_x.numel() * state_x.element_size()
    return rec


def _param_bytes(net: DiTConfig, dtype: torch.dtype) -> int:
    """The bytes of the whole DiT stored at ``dtype``."""
    shapes = []
    tree_map_with_path(lambda _, shape: shapes.append(shape), dit_param_shapes(net))
    elem = torch.empty((), dtype=dtype).element_size()
    return sum(elem * int(torch.Size(s).numel()) for s in shapes)


def mesh_iteration(model: DiT, sde, cfg: AdaptiveConfig, x, *, mesh: Optional[Mesh] = None,
                   pipeline: bool = False, sharded_rows: bool = False):
    """(body, carry, forward) of one Algorithm-1 iteration of ``model``
    (the rank's DiT) on the state ``x`` (the rank's rows): the body with
    the plain step math and ``torch.randn_like`` noise, the forward
    tensor-parallel under ``mesh`` (or pipelined over "pod" with
    ``pipeline``, ``PIPELINE_MICROBATCHES`` microbatches, the rows
    gathered over "pod" first where ``sharded_rows``). The dry runs count
    it on meta tensors; the tests and the self-test run it for real."""
    policy = resolve_policy(cfg.precision)
    if pipeline:
        fwd = make_pipelined_dit_forward(model, num_microbatches=PIPELINE_MICROBATCHES,
                                         policy=policy, mesh=mesh, sharded_rows=sharded_rows)
    else:
        fwd = lambda m, x, t: dit_forward(m, x, t, policy=policy, mesh=mesh)
    step = make_sample_step(sde, cfg, forward_fn=fwd)
    carry = ad.init_carry(sde, x, None, config=cfg)
    body = ad._make_body(sde, step.score_of(model), cfg, float(sde.abs_tolerance),
                         ad._step_math_jnp, noise_fn=torch.randn_like)
    return body, carry, lambda x, t: fwd(model, x, t)


def _save(rec: dict, out_dir: str, policy) -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if policy.is_fp32 else f"_{policy.name}"
    with open(os.path.join(out_dir, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json"),
              "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)


def dryrun(batch: int = 512, precision: str = "fp32", *, arch: str = "highres_dit",
           mesh: str = "1card", pipeline: bool = False, out_dir: str = DRYRUN_DIR,
           save: bool = True) -> dict:
    """One Algorithm-1 iteration of ``arch`` on the VE SDE (σ_max 50, the
    paper's high-resolution process, eps_rel 0.02), counted on meta
    tensors under ``precision`` (reference :236); one forward counted
    alone gives the per-NFE FLOPs and bytes. The plain attention and step
    math run (``use_flash=False``, ``use_fused_kernel=False``): the
    kernels' wrappers take CPU or CUDA tensors only.

    ``mesh`` "1pod" / "2pod" counts the first rank of the reference's
    production mesh: its rows of the state (``parallel.sharding.
    batch_sharding`` over the data axes), its blocks of the weights
    (``_dit_param_shardings``), and every collective it calls, inside
    ``coll.counting()``, in the record's ``collectives``. ``pipeline``
    (2pod only, as the reference asserts) cuts the layers over "pod" and
    runs the pipelined forward on the rank's "data" rows gathered over
    "pod"."""
    if mesh not in DRYRUN_MESHES:
        raise ValueError(f"mesh {mesh!r}: want one of {DRYRUN_MESHES}")
    if pipeline and mesh != "2pod":
        raise ValueError("pipeline stages live on the pod axis (the 2pod mesh)")
    meta = torch.device("meta")
    net = dataclasses.replace(ARCHS[arch], use_flash=False)
    sde = VESDE(sigma_max=50.0)
    policy = resolve_policy(precision)
    cfg = AdaptiveConfig(eps_rel=0.02, precision=policy)
    shape = (batch, net.image_size, net.image_size, net.channels)
    m, rows, shardings = None, slice(None), None
    if mesh != "1card":
        m = make_production_mesh(multi_pod=mesh == "2pod")
        rs = batch_sharding(m, batch, len(shape))
        rows = rs.rows
        shardings = _dit_param_shardings(net, m, pipeline_axis="pod" if pipeline else None)
    model = policy.cast_params(DiT(net, device=meta, shardings=shardings))
    x = torch.empty(shape, device=meta)[rows]
    body, carry, fwd = mesh_iteration(model, sde, cfg, x, mesh=m, pipeline=pipeline,
                                      sharded_rows=m is not None and not rs.replicated)
    coll.reset()
    with torch.no_grad(), coll.counting():
        it = count(body, carry)
        collectives = coll.books()
        nfe = count(fwd, carry.x, carry.t)
    coll.reset()
    rec = {"arch": f"dit-{arch.removesuffix('_dit')}-sampler" + ("-pipelined" if pipeline else ""),
           "shape": f"sample_b{batch}_{net.image_size}px", "mesh": mesh,
           "devices": 1 if m is None else m.size, "dtype": policy.compute_dtype,
           "cost": it, "per_nfe": {"flops": nfe["flops"], "bytes": nfe["est_hbm_traffic_bytes"]},
           "collectives": collectives,
           "precision": _precision_record(policy, _param_bytes(net, policy.param), carry.x),
           "note": "one Algorithm-1 iteration (2 score-net forwards + step math)"
                   + ("" if m is None else "; one rank, every layer counted")}
    if m is not None:
        rec["rank"] = {"coordinate": dict(zip(m.axis_names, m.coordinate)),
                       "rows": carry.x.shape[0],
                       "layers": [model.layer_range.start, model.layer_range.stop],
                       "param_bytes": sum(p.numel() * p.element_size()
                                          for p in model.parameters())}
        if pipeline:
            rec["rank"]["microbatches"] = PIPELINE_MICROBATCHES
    if save:
        _save(rec, out_dir, policy)
    print(f"[{rec['arch']} × {rec['shape']} × {mesh}, {policy.name}] flops {it['flops']:.3e} "
          f"(a forward {nfe['flops']:.3e}), traffic {it['est_hbm_traffic_bytes'] / 2**30:.2f} "
          f"GiB, weights {rec['precision']['param_bytes_total'] / 2**30:.3f} GiB, state "
          f"{rec['precision']['state_bytes_per_device'] / 2**30:.3f} GiB a device, "
          f"collectives {collectives['total_bytes'] / 2**20:.2f} MiB "
          f"{collectives['bytes_by_kind']}")
    return rec


def dryrun_loop(batch: int = 256, precision: str = "fp32", *, devices: int = 64,
                out_dir: str = DRYRUN_DIR, save: bool = True) -> dict:
    """The whole sharded sampling loop of CIFAR_DIT (VP, eps_rel 0.02) on a
    ``("data",)`` mesh of ``devices`` ranks, weights replicated, counted
    on meta tensors for the first rank (reference :312-373): the prior,
    one loop body (two forwards and the step math), the loop control of a
    sync group (``adaptive.sync_flags``: one ``all_reduce(MAX)``) and the
    Tweedie denoise. The trip count depends on the data and is not in
    the count (XLA's ``cost_analysis`` also counts the while body once);
    ``cost.total`` is the prior, one iteration, one sync and the denoise.
    The collectives are loop bookkeeping: none is activation-sized."""
    if devices < 1 or batch % devices:
        raise ValueError(f"batch {batch} must divide over {devices} devices")
    meta = torch.device("meta")
    net = ARCHS["cifar_dit"]
    sde = VPSDE()
    policy = resolve_policy(precision)
    cfg = AdaptiveConfig(eps_rel=0.02, precision=policy)
    m = Mesh(("data",), (devices,), (0,), device=meta)
    shape = (batch, net.image_size, net.image_size, net.channels)
    sharding = batch_sharding(m, batch, len(shape))
    local = (batch // devices,) + shape[1:]
    model = policy.cast_params(DiT(net, device=meta))
    x = torch.empty(local, device=meta)
    body, carry, _ = mesh_iteration(model, sde, cfg, x)
    score = make_sample_step(sde, cfg).score_of(model)
    parts, colls = {}, {}
    with torch.no_grad(), coll.counting():
        for name, fn, args in (
                ("prior", lambda: torch.randn(local, device=meta) * sde.prior_std(), ()),
                ("body", body, (carry,)),
                ("loop_control", lambda c: ad.sync_flags(c, sharding), (carry,)),
                ("denoise", lambda c: ad.finalize(sde, score, c, precision=policy).x,
                 (carry,))):
            coll.reset()
            parts[name] = count(fn, *args)
            colls[name] = coll.books()
    coll.reset()
    total = {k: sum(p[k] for p in parts.values())
             for k in ("flops", "est_hbm_traffic_bytes")}
    per_iteration = colls["body"]["total_bytes"] + colls["loop_control"]["total_bytes"]
    rec = {"arch": "dit-cifar-sampler-whole-loop", "shape": f"sample_b{batch}_32px",
           "mesh": f"data{devices}", "devices": devices, "dtype": policy.compute_dtype,
           "cost": {"total": total, **parts}, "collectives": colls,
           "collective_bytes_per_iteration": per_iteration,
           "precision": _precision_record(policy, _param_bytes(net, policy.param), x),
           "note": "prior + one loop body + one sync group's loop control + the Tweedie "
                   "denoise, batch sharded, weights replicated; the trip count is "
                   "data-dependent and not in the count (XLA's cost_analysis also counts the "
                   "while body once)"}
    if save:
        _save(rec, out_dir, policy)
    print(f"[{rec['arch']} × {rec['shape']} × {rec['mesh']}, {policy.name}] flops "
          f"{total['flops']:.3e} (an iteration {parts['body']['flops']:.3e}), collectives "
          f"an iteration {rec['collective_bytes_per_iteration']} B "
          f"{colls['loop_control']['bytes_by_kind']}")
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
    meshes = ap.add_mutually_exclusive_group()
    meshes.add_argument("--mesh", choices=DRYRUN_MESHES[:2], default="1card",
                        help="the dry run's mesh: one card, or one rank of the "
                             "reference's 1pod (16, 16) mesh")
    meshes.add_argument("--multi-pod", action="store_true",
                        help="the dry run on one rank of the 2pod (2, 16, 16) mesh")
    ap.add_argument("--pipeline", action="store_true",
                    help="the dry run's forward as GPipe stages over 'pod' (with --multi-pod)")
    ap.add_argument("--dryrun-loop", action="store_true",
                    help="count the whole sharded loop of CIFAR_DIT (default batch 256)")
    ap.add_argument("--loop-devices", type=int, default=64,
                    help="ranks of the ('data',) mesh of --dryrun-loop")
    ap.add_argument("--out", default=DRYRUN_DIR, help="the dry run's record directory")
    ap.add_argument("--cfg-scale", type=float, default=None,
                    help="classifier-free guidance at this scale on the --arch DiT made "
                         "class-conditional, one adaptive solve (DESIGN.md §9)")
    ap.add_argument("--inpaint", action="store_true",
                    help="checkerboard inpainting on the --arch DiT, one adaptive solve "
                         "(post-accept projection, DESIGN.md §9)")
    args = ap.parse_args(argv)
    if args.dryrun or args.multi_pod or args.pipeline or args.mesh != "1card":
        return [dryrun(args.batch or 512, args.precision, arch=args.arch or "highres_dit",
                       mesh="2pod" if args.multi_pod else args.mesh,
                       pipeline=args.pipeline, out_dir=args.out)]
    if args.dryrun_loop:
        return [dryrun_loop(args.batch or 256, args.precision, devices=args.loop_devices,
                            out_dir=args.out)]
    args.arch, args.batch = args.arch or "cifar_dit", args.batch or 8
    mesh, device = None, args.device
    methods = (("adaptive", {}), ("em", dict(n_steps=100)))
    guide = {}
    if args.cfg_scale is not None:  # the reference's precedence: guidance, then inpainting
        guide = dict(cfg_scale=args.cfg_scale)
    elif args.inpaint:
        guide = dict(inpaint=True)
    if guide:
        methods = methods[:1]
        if "WORLD_SIZE" in os.environ:
            ap.error("--cfg-scale and --inpaint run on one device, as the reference's "
                     "demos do: not under torchrun")
    if "WORLD_SIZE" in os.environ:
        mesh = torchrun_mesh(args.device)
        device = mesh.device
    recs = []
    for method, kw in methods:
        rec = run(args.arch, batch=args.batch, precision=args.precision,
                  eps_rel=args.eps_rel, max_iters=args.max_iters, flash=args.flash,
                  fused=args.fused, seed=args.seed, liven_seed=args.liven_seed,
                  device=device, method=method, mesh=mesh, **guide, **kw)
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
