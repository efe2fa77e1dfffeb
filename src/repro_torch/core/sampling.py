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
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.sde import SDE
from repro_torch.core.solvers import SolveResult, get_solver
from repro_torch.core.solvers.adaptive import (
    AdaptiveConfig, finalize, init_carry, resolve_config, solve_chunk,
    sync_state,
)
from repro_torch.device import resolve_device


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def sample(sde: SDE, score_fn: Callable, shape, *, seed: int = 0,
           method: str = "adaptive", denoise: bool = True, device="cuda",
           cond=None, **solver_kwargs) -> SolveResult:
    """Generate ``shape[0]`` samples of shape ``shape[1:]`` on ``device``
    (``cuda`` unless the caller passes ``"cpu"``). ``cond`` is the
    per-sample payload of the conditioner in the solver's config (with a
    ``ClassifierFree`` conditioner the score is ``s(x, t, y)``)."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    x_init = sde.prior_sample(shape, gen)
    solver = get_solver(method)
    if cond is not None:
        solver_kwargs["cond"] = cond
    return solver(sde, score_fn, x_init, gen, denoise=denoise, device=dev,
                  **solver_kwargs)


def solve_in_chunks(sde: SDE, score_fn: Callable, shape, *, max_sync_iters: int,
                    seed: int = 0, config: AdaptiveConfig | None = None,
                    denoise: bool = True, device="cuda", cond=None,
                    on_sync: Callable | None = None,
                    noise_fn: Callable | None = None,
                    **overrides) -> SolveResult:
    """Adaptive solve as a chain of ``solve_chunk`` calls of at most
    ``max_sync_iters`` iterations; ``on_sync(carry)`` sees every
    intermediate carry. Bitwise equal to ``sample(method="adaptive")``
    for the same seed."""
    cfg = resolve_config(config, overrides)
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    carry = init_carry(sde, sde.prior_sample(shape, gen), gen, config=cfg,
                       cond=cond)
    while True:
        done, iters = sync_state(carry)
        if done or iters >= cfg.max_iters:
            break
        carry = solve_chunk(sde, score_fn, carry, max_sync_iters=max_sync_iters,
                            config=cfg, noise_fn=noise_fn)
        if on_sync is not None:
            on_sync(carry)
    return finalize(sde, score_fn, carry, denoise=denoise,
                    precision=cfg.precision, conditioner=cfg.conditioner)
