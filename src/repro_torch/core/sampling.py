"""Sampling entry point: prior draw → solver → denoised samples; port of
``repro/core/sampling.py`` (``sample`` and ``solve_in_chunks``;
``sample_chunked`` is not ported yet).

``sample`` ties the pipeline together (DESIGN.md §1) for every
registered solver (``adaptive``, ``em``, ``pc``, ``pc_hmc``, ``ddim``,
``ode``): one ``torch.Generator`` on the target device, seeded by the
caller, draws the prior and then every noise draw of the solve; a
``noise_fn`` in the solver's keywords replaces those draws. ``solve_in_chunks``
is the resumable form (DESIGN.md §7): the same adaptive solve as a
host-driven chain of ``solve_chunk`` calls, bitwise equal to
``sample(method="adaptive")`` for the same seed. Both take the optional
condition payload ``cond`` of ``AdaptiveConfig.conditioner``
(DESIGN.md §9), which rides in the carry through every chunk.

Under ``mesh=`` (a ``repro_torch.parallel.Mesh`` over
``torch.distributed``, DESIGN.md §3) both are data-parallel: every rank
draws the global prior from the same seed, the batch shards over the
mesh's data axes (``sample_state_shardings``; an indivisible batch
replicates), the adaptive solver runs on this rank's rows, and the
result holds those rows. ``gather_result`` assembles the whole batch.
The fixed-grid baselines and the ODE are not data-parallel yet (ROADMAP
A11) and raise under a mesh rather than solve the whole batch on every
rank.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable

import torch

from repro_torch.core.sde import SDE
from repro_torch.core.solvers import SolveResult, get_solver
from repro_torch.core.solvers.adaptive import (
    AdaptiveConfig, finalize, init_carry, resolve_config, solve_chunk,
    sync_state,
)
from repro_torch.device import resolve_device
from repro_torch.parallel.collectives import gather_rows
from repro_torch.parallel.sharding import sample_state_shardings


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


@functools.cache
def _accepts_sharding(solver: Callable) -> bool:
    return "sharding" in inspect.signature(solver).parameters


def _state_sharding(mesh, shape, dev: torch.device):
    """The batch sharding of the state under ``mesh`` (None without one)."""
    if mesh is None:
        return None
    if mesh.device.type != dev.type:
        raise ValueError(f"mesh on {mesh.device}, sampling on {dev}")
    return sample_state_shardings(mesh, shape[0], len(shape))[0]


def sample(sde: SDE, score_fn: Callable, shape, *, seed: int = 0,
           method: str = "adaptive", denoise: bool = True, device="cuda",
           mesh=None, cond=None, **solver_kwargs) -> SolveResult:
    """Generate ``shape[0]`` samples of shape ``shape[1:]`` on ``device``
    (``cuda`` unless the caller passes ``"cpu"``). ``cond`` is the
    per-sample payload of the conditioner in the solver's config (with a
    ``ClassifierFree`` conditioner the score is ``s(x, t, y)``).

    ``mesh`` shards the batch over the mesh's data axes: the result holds
    this rank's rows (``gather_result`` collects the batch), the
    unsharded result's rows (bit for bit where a row's score does not
    depend on the batch around it). Only solvers that take a
    ``sharding`` (the adaptive solver) run under a mesh; the others raise
    ``NotImplementedError`` (ROADMAP A11).
    """
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    x_init = sde.prior_sample(shape, gen)
    solver = get_solver(method)
    if cond is not None:
        solver_kwargs["cond"] = cond
    sharding = _state_sharding(mesh, shape, dev)
    if sharding is not None:
        if not _accepts_sharding(solver):
            raise NotImplementedError(
                f"solver '{method}' is not data-parallel yet (ROADMAP A11): "
                "only the adaptive solver runs under mesh=")
        solver_kwargs["sharding"] = sharding
    return solver(sde, score_fn, x_init, gen, denoise=denoise, device=dev,
                  **solver_kwargs)


def gather_result(res: SolveResult, mesh, batch: int) -> SolveResult:
    """The whole batch's ``SolveResult`` from every rank's rows of a
    ``sample(mesh=)`` or ``solve_in_chunks(mesh=)`` of ``batch`` samples
    (a collective: every rank of the mesh calls it)."""
    arr, vec, _ = sample_state_shardings(mesh, batch, res.x.ndim)
    return SolveResult(
        x=gather_rows(res.x, mesh, arr), nfe=gather_rows(res.nfe, mesh, vec),
        iterations=res.iterations, accepted=gather_rows(res.accepted, mesh, vec),
        rejected=gather_rows(res.rejected, mesh, vec))


def solve_in_chunks(sde: SDE, score_fn: Callable, shape, *, max_sync_iters: int,
                    seed: int = 0, config: AdaptiveConfig | None = None,
                    denoise: bool = True, device="cuda", mesh=None, cond=None,
                    on_sync: Callable | None = None,
                    noise_fn: Callable | None = None,
                    **overrides) -> SolveResult:
    """Adaptive solve as a chain of ``solve_chunk`` calls of at most
    ``max_sync_iters`` iterations; ``on_sync(carry)`` sees every
    intermediate carry. Bitwise equal to ``sample(method="adaptive")``
    for the same seed, with or without ``mesh`` (this rank's rows)."""
    cfg = resolve_config(config, overrides)
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    sharding = _state_sharding(mesh, shape, dev)
    carry = init_carry(sde, sde.prior_sample(shape, gen), gen, config=cfg,
                       cond=cond, sharding=sharding)
    while True:
        done, iters = sync_state(carry, sharding)
        if done or iters >= cfg.max_iters:
            break
        carry = solve_chunk(sde, score_fn, carry, max_sync_iters=max_sync_iters,
                            config=cfg, noise_fn=noise_fn, sharding=sharding)
        if on_sync is not None:
            on_sync(carry)
    return finalize(sde, score_fn, carry, denoise=denoise,
                    precision=cfg.precision, conditioner=cfg.conditioner)
