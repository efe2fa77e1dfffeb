"""Sampling entry point: prior draw → solver → denoised samples; port of
``repro/core/sampling.py`` (``sample``, ``solve_in_chunks`` and
``sample_chunked``).

``sample`` ties the pipeline together (DESIGN.md §1) for every
registered solver (``adaptive``, ``em``, ``pc``, ``pc_hmc``, ``ddim``,
``ode``): one ``torch.Generator`` on the target device, seeded by the
caller, draws the prior and then every noise draw of the solve; a
``noise_fn`` in the solver's keywords replaces those draws. ``solve_in_chunks``
is the resumable form (DESIGN.md §7): the same adaptive solve as a
host-driven chain of ``solve_chunk`` calls (or of a caller's prebuilt
``chunk_fn``), bitwise equal to ``sample(method="adaptive")`` for the
same seed. ``sample_chunked`` draws many samples as a chain of
``sample`` calls and hands them back as host numpy. The first two take the optional
condition payload ``cond`` of ``AdaptiveConfig.conditioner``
(DESIGN.md §9), which rides in the carry through every chunk.

Under ``mesh=`` (a ``repro_torch.parallel.Mesh`` over
``torch.distributed``, DESIGN.md §3) both are data-parallel: every rank
draws the global prior from the same seed, the batch shards over the
mesh's data axes (``sample_state_shardings``; an indivisible batch
replicates), every registered solver runs on this rank's rows (the
adaptive families, the fixed-grid baselines with the global draws cut to
the rank's rows, the ODE with its batch-global error all-reduced), and
the result holds those rows. ``gather_result`` assembles the whole
batch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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

Tensor = torch.Tensor


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


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

    ``mesh`` shards the batch over the mesh's data axes for every
    solver: the result holds this rank's rows (``gather_result`` collects
    the batch), the unsharded result's rows (bit for bit where a row's
    score does not depend on the batch around it).
    """
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    x_init = sde.prior_sample(shape, gen)
    solver = get_solver(method)
    if cond is not None:
        solver_kwargs["cond"] = cond
    sharding = _state_sharding(mesh, shape, dev)
    if sharding is not None:
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
                    chunk_fn: Callable | None = None,
                    **overrides) -> SolveResult:
    """Adaptive solve as a chain of ``solve_chunk`` calls of at most
    ``max_sync_iters`` iterations; ``on_sync(carry)`` sees every
    intermediate carry. Bitwise equal to ``sample(method="adaptive")``
    for the same seed, with or without ``mesh`` (this rank's rows).

    ``chunk_fn`` is a prebuilt ``carry -> carry`` chunk that replaces
    the default ``solve_chunk`` call; ``max_sync_iters`` and ``noise_fn``
    then belong to it, and the chain stops on the carry's global done
    flag or ``max_iters``, as with the default chunk. It mirrors the
    reference's seam, which there reuses a prebuilt jitted chunk to
    avoid a recompile; eager PyTorch has nothing to prebuild, so nothing
    in this package passes it yet. Its intended caller is a captured
    CUDA graph of one ``SYNC_EVERY`` group."""
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
        if chunk_fn is not None:
            carry = chunk_fn(carry)
        else:
            carry = solve_chunk(sde, score_fn, carry, max_sync_iters=max_sync_iters,
                                config=cfg, noise_fn=noise_fn, sharding=sharding)
        if on_sync is not None:
            on_sync(carry)
    return finalize(sde, score_fn, carry, denoise=denoise,
                    precision=cfg.precision, conditioner=cfg.conditioner)


def chunk_seeds(seed: int, n: int) -> list:
    """The seeds of ``sample_chunked``'s chunks: n independent 63-bit
    integers from ``numpy.random.SeedSequence(seed)`` (the reference
    splits its key once per chunk)."""
    state = np.random.SeedSequence(seed).generate_state(2 * n, dtype=np.uint32)
    return [int((int(state[2 * i]) << 31) ^ int(state[2 * i + 1])) for i in range(n)]


def _start_copy(x: Tensor, nfe: Tensor, done, stream):
    """Queue the device→host copy of a chunk's (x, nfe) on ``stream``
    once the chunk's own work (event ``done``) is finished, into pinned
    buffers; returns (event, buffers). CPU results need no copy."""
    if done is None:
        return None, (x, nfe)
    bufs = []
    with torch.cuda.stream(stream):
        stream.wait_event(done)
        for t in (x, nfe):
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            t.record_stream(stream)  # the allocator must not reuse t before the copy ran
            bufs.append(buf)
        copied = torch.cuda.Event()
        copied.record(stream)
    return copied, bufs


def sample_chunked(sde: SDE, score_fn: Callable, n_samples: int, sample_shape, *,
                   seed: int = 0, chunk: int = 64, method: str = "adaptive",
                   device="cuda", mesh=None, **solver_kwargs):
    """Generate ``n_samples`` samples in chunks of ``chunk``, each a
    ``sample`` call with its own seed (``chunk_seeds``); returns
    (samples (N, ...) fp32 host numpy, mean NFE as a float).

    The chunks are joined on the host with ``np.concatenate``, never on
    the device. On the card chunk i is copied out only after chunk i + 1
    has been dispatched: its copy waits on an event recorded right after
    its own dispatch and runs on a side stream into pinned memory, so
    it overlaps chunk i + 1's compute where the solver's launches run
    ahead of the host. ``mesh`` shards each chunk as in ``sample``, and
    every rank gets the whole result (a collective: every rank calls it).
    """
    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    n_chunks = -(-n_samples // chunk)
    copies, pending = [], None
    for s in chunk_seeds(seed, n_chunks):
        res = sample(sde, score_fn, (chunk,) + tuple(sample_shape), seed=s, method=method,
                     device=dev, mesh=mesh, **solver_kwargs)
        if mesh is not None:
            res = gather_result(res, mesh, chunk)
        x = res.x.to(torch.float32)
        done = None
        if stream is not None:  # the chunk's work, the cast included, is enqueued
            done = torch.cuda.Event()
            done.record()
        if pending is not None:  # chunk i - 1, now that chunk i is dispatched
            copies.append(_start_copy(*pending, stream))
        pending = (x, res.nfe, done)
    copies.append(_start_copy(*pending, stream))
    xs, nfes = [], []
    for copied, (x, nfe) in copies:
        if copied is not None:
            copied.synchronize()
        xs.append(x.numpy())
        nfes.append(nfe.numpy())
    x = np.concatenate(xs)[:n_samples]
    nfe = np.concatenate(nfes)[:n_samples]
    return x, float(nfe.mean())
