"""Sampling entry point: prior draw → solver → denoised samples; port of
``repro/core/sampling.py`` (``sample``, ``solve_in_chunks`` and
``sample_chunked``).

``sample`` ties the pipeline together (DESIGN.md §1) for every
registered solver (``adaptive``, ``momentum``, ``heun``, ``em``, ``pc``,
``pc_hmc``, ``ddim``, ``ode``). Its noise is per-row Philox streams
(``seed_streams``): row i's stream seed is ``chunk_seeds(seed, B)[i]``
(``numpy.random.SeedSequence(seed)``). Every method draws its prior from
the streams at counter 0, so one seed gives every method the same prior
(the reference's ``k_prior`` split), and its noise from the same streams
from counter 1. A row of ``sample(seed=s)`` is then bitwise a solo solve
on that row's stream for the Algorithm-1 families and the fixed-grid
baselines (not for the ODE, whose error is batch-global), and every
solve can run as one captured CUDA graph (the solver's graphed loop,
``core.solvers.adaptive.graphable``). A ``noise_fn`` in the solver's
keywords replaces the solver's draws (the prior stays the streams'); a
``torch.Generator`` reaches a solver only from a caller who passes one
to it. ``solve_in_chunks`` is the resumable form (DESIGN.md §7): the
same adaptive solve as a chain of
chunks of ``max_sync_iters`` iterations with a host read between them,
bitwise equal to ``sample(method="adaptive")`` for the same seed.
``sample_chunked`` draws many samples as a chain of ``sample`` calls
and hands them back as host numpy. The first two take the optional
condition payload ``cond`` of ``AdaptiveConfig.conditioner`` (DESIGN.md
§9), which rides in the carry through every chunk.

Both run their graphed solves through the solvers' bounded graph cache
(``core.solvers.adaptive.cached_driver``, the reference's
``_chunk_jit``/``_finalize_jit``) under its one-shot rule: a key's first
solve runs host-driven and records the key, the second captures, and a
later solve at the same key copies its fresh carry into the cached
driver's captured buffers and launches it, capturing nothing.

Under ``mesh=`` (a ``repro_torch.parallel.Mesh`` over
``torch.distributed``, DESIGN.md §3) both are data-parallel: every rank
draws the global prior from the same streams, the batch shards over the
mesh's data axes (``sample_state_shardings``; an indivisible batch
replicates), every registered solver runs on this rank's rows (the
adaptive families and the fixed-grid baselines on the rank's rows of
the streams, the ODE with its batch-global error all-reduced), and the
result holds those rows. ``gather_result`` assembles the whole batch
(a host collective after the solve). The solves are graphed through the
same cache on the card on an NCCL mesh, whose collectives the graph
captures (the mesh's flags of Algorithm 1's horizon, the RK45's error
sum), and on the CPU's plain driver under any backend; the ranks agree
on the one-shot rule's branch before each solve. On the card a gloo
mesh stays host-driven: gloo collectives cannot be captured.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from repro_torch.core import streams
from repro_torch.core.sde import SDE
from repro_torch.core.solvers import SolveResult, get_solver
from repro_torch.core.solvers.adaptive import (
    AdaptiveConfig, driver_window, finalize, graph_driver, graphable, init_carry,
    resolve_config, solve_chunk, sync_state,
)
from repro_torch.device import resolve_device
from repro_torch.parallel.collectives import gather_rows
from repro_torch.parallel.sharding import sample_state_shardings

Tensor = torch.Tensor


def seed_streams(seed: int, batch: int, device="cuda") -> streams.SlotStreams:
    """``sample``'s per-row streams at counter 0 on ``device`` (``cuda``
    unless the caller passes ``"cpu"``): row i's seed is
    ``chunk_seeds(seed, batch)[i]``."""
    return streams.SlotStreams.of(chunk_seeds(seed, batch), 0, device=device)


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

    The prior is the streams' draw at counter 0 (``seed_streams``) and
    every method's noise comes from the same streams from counter 1
    (module docstring). The solve is graphed unless the solver's
    keywords hold a ``noise_fn`` or ``mesh`` is a gloo mesh on the card
    (then host-driven), and a key's first solve is host-driven too (the
    one-shot rule).

    ``mesh`` shards the batch over the mesh's data axes for every
    solver: the result holds this rank's rows (``gather_result`` collects
    the batch), the unsharded result's rows (bit for bit where a row's
    score does not depend on the batch around it).
    """
    dev = resolve_device(device)
    st = seed_streams(seed, shape[0], dev)
    x_init = sde.prior_sample(shape, st)
    solver = get_solver(method)
    if cond is not None:
        solver_kwargs["cond"] = cond
    sharding = _state_sharding(mesh, shape, dev)
    if sharding is not None:
        solver_kwargs["sharding"] = sharding
    return solver(sde, score_fn, x_init, st.advanced(1), denoise=denoise, device=dev,
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
    """Adaptive solve as a chain of chunks of at most ``max_sync_iters``
    iterations, one host read after each; ``on_sync(carry)`` sees every
    intermediate carry (a copy). Bitwise equal to
    ``sample(method="adaptive")`` for the same seed, with or without
    ``mesh`` (this rank's rows).

    A chunk is one window of the cached driver whose horizon is
    ``max_sync_iters`` iterations (``graph_driver``): on the card one
    replay of a captured graph a sync, captured once a key; on the CPU a
    ``solve_chunk`` call (under ``mesh`` the masked horizon the card
    captures, ended by the mesh's flags). With ``noise_fn`` (Python a
    graph cannot call), a gloo ``mesh`` on the card (a collective a graph
    cannot capture) or ``chunk_fn`` the chain
    is host-driven: ``chunk_fn`` is a prebuilt ``carry -> carry`` chunk
    that replaces the default ``solve_chunk`` call (``max_sync_iters``
    and ``noise_fn`` then belong to it), the reference's seam for a
    prebuilt jitted chunk, and the chain stops on the carry's global
    done flag or ``max_iters``, as with the default chunk."""
    cfg = resolve_config(config, overrides)
    dev = resolve_device(device)
    st = seed_streams(seed, shape[0], dev)
    sharding = _state_sharding(mesh, shape, dev)
    carry = init_carry(sde, sde.prior_sample(shape, st), st.advanced(1), config=cfg,
                       cond=cond, sharding=sharding)
    drv = None
    if chunk_fn is None and graphable(carry.generator, noise_fn, sharding):
        drv = graph_driver(sde, score_fn, carry, cfg, max_sync_iters=max_sync_iters,
                           max_horizons=1, sharding=sharding)
    if drv is not None:
        while cfg.max_iters > 0:
            horizons, active, iters = driver_window(drv)
            if not horizons:  # every row had converged before the chunk
                break
            if on_sync is not None:
                on_sync(copy.deepcopy(drv.carry))
            if not active or iters >= cfg.max_iters:
                break
        carry = copy.deepcopy(drv.carry)
    else:
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
    """n independent non-negative 63-bit integers from
    ``numpy.random.SeedSequence(seed)``: with its 2n 32-bit words w,
    seed i is (w[2i] << 31) ^ w[2i + 1]. The seeds of ``sample_chunked``'s
    chunks (the reference splits its key once per chunk) and of
    ``sample``'s per-row streams."""
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
