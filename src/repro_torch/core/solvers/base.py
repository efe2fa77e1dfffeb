"""Common solver API; port of ``repro/core/solvers/base.py``.

A solver consumes an SDE, a score function s(x, t) (t a per-sample
vector), an initial state drawn from the prior and a generator, and
returns a ``SolveResult``. Every solver takes the same keywords besides
its own: ``denoise``, ``device`` (``cuda`` unless the caller passes
``"cpu"``), ``noise_fn`` and ``sharding`` (under a mesh: the state's
batch sharding, ``sample(mesh=)``; the solve then runs on this rank's
rows and returns them). ``noise_fn(x) -> z`` replaces each normal
draw from the generator; the parity tests pass the reference's own
noise through it, since JAX's threefry and torch's generators never give
the same numbers. Solvers that draw nothing ignore it.

``SlotStreams`` (``core/streams.py``) is the port of the reference's
(B, 2) per-slot keys, the third form of ``draw_noise``'s generator and
the one ``sample`` hands every solver: a solve whose noise is a
``SlotStreams`` (or that draws none), with no ``noise_fn`` and no mesh,
can run as one captured CUDA graph (``adaptive.graphable``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.core.sde import SDE
from repro_torch.core.streams import SlotStreams

Tensor = torch.Tensor


@dataclasses.dataclass
class SolveResult:
    """Output of a solver run.

    x: final samples (B, ...). nfe: per-sample score evaluations (B,).
    iterations: solver loop iterations in which some sample was active
    (0-d). accepted / rejected: per-sample step counts (B,).
    """

    x: Tensor
    nfe: Tensor
    iterations: Tensor
    accepted: Tensor
    rejected: Tensor

    @property
    def mean_nfe(self) -> Tensor:
        return self.nfe.to(torch.float32).mean()

    @property
    def max_nfe(self) -> Tensor:
        return self.nfe.max()


_REGISTRY: Dict[str, Callable[..., Any]] = {}
#: solver name → score evaluations per loop iteration (int or callable
#: over the solver's keyword arguments), as in the reference
_NFE_PER_ITER: Dict[str, Any] = {}


def register_solver(name: str, *, nfe_per_iter: Any = None):
    def deco(fn):
        _REGISTRY[name] = fn
        if nfe_per_iter is not None:
            _NFE_PER_ITER[name] = nfe_per_iter
        return fn

    return deco


def solver_nfe_per_iteration(name: str, **solver_kwargs) -> int:
    """Score evaluations one loop iteration of ``name`` issues; raises
    ``ValueError`` for unknown solvers and solvers without a rule."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown solver '{name}'; available: {sorted(_REGISTRY)}")
    try:
        rule = _NFE_PER_ITER[name]
    except KeyError:
        raise ValueError(f"solver '{name}' declared no per-iteration NFE rule") from None
    return int(rule(**solver_kwargs)) if callable(rule) else int(rule)


def draw_noise(generator, noise_fn: Callable | None, x: Tensor,
               sharding=None, offset: int = 0) -> Tensor:
    """z ~ N(0, I) shaped like x: from ``noise_fn`` if given, else drawn
    from ``generator`` in fp32; cast to x's dtype and device.

    ``generator`` takes one of three forms. One ``torch.Generator`` for
    the batch. A ``SlotStreams`` (the reference's per-slot keys as device
    data): row i of z is P1's draw of stream (seed[i], counter[i] +
    ``offset``), one kernel launch for the batch, so a sample's noise
    does not depend on its slot or its seatmates, and an idle row
    (seed < 0) is 0. Or a list of x.shape[0] per-slot sources: a
    callable ``source(shape) -> Tensor`` of one row's shape (the seam
    through which tests hand every slot the reference's own per-request
    draws) or None for an idle slot, whose row is 0.

    Under a mesh, x holds this rank's rows of the ``sharding``. A
    ``torch.Generator`` or a ``noise_fn`` draws the whole batch
    (``noise_fn`` is handed an uninitialised tensor of the global shape)
    and the rank keeps its rows: every rank draws the same numbers from
    its copy of the generator, so a sharded solve sees the unsharded
    solve's noise, row for row. Per-slot streams are sharded with the
    state (``solver_carry_shardings(per_slot_keys=True)``): a
    ``SlotStreams`` or a list holds this rank's rows only and draws them
    directly, each row the unsharded row bit for bit, since a row's draw
    depends on its own stream alone.
    """
    if isinstance(generator, (SlotStreams, list)) and noise_fn is None:
        if isinstance(generator, SlotStreams):
            return generator.draw(x.shape[1:], offset).to(x.dtype)
        if len(generator) != x.shape[0]:
            raise ValueError(f"{len(generator)} per-slot sources for {x.shape[0]} rows")
        z = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        for row, src in zip(z, generator):
            if src is None:
                row.zero_()
            else:
                row.copy_(src(tuple(row.shape)))
        return z.to(x.dtype)
    shape = x.shape if sharding is None else sharding.global_shape(x.shape)
    if noise_fn is not None:
        z = noise_fn(x if sharding is None else x.new_empty(shape))
        z = z.to(device=x.device, dtype=x.dtype)
    else:
        z = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=x.device).to(x.dtype)
    return z if sharding is None else sharding.local(z)


def local_state(x_init: Tensor, dev: torch.device, sharding=None) -> Tensor:
    """A solver's starting state on ``dev``: the global ``x_init``, or under
    a mesh this rank's rows of it (``sharding``, the state's batch
    sharding). The fixed-grid solvers then run row by row on those rows,
    each row the unsharded solve's row."""
    x = x_init.to(dev)
    return x if sharding is None else sharding.local(x)


def check_noise_source(generator, noise_fn: Callable | None, dev: torch.device,
                       name: str) -> None:
    """A stochastic solver needs a generator (or ``SlotStreams``) on
    ``dev``, or a noise_fn."""
    if noise_fn is None:
        if generator is None:
            raise ValueError(f"{name} needs a generator or a noise_fn")
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, solve on {dev}")


def fixed_grid_result(x: Tensor, n_steps: int, nfe_per_step: int) -> SolveResult:
    """SolveResult of a fixed-grid solve: every sample spent
    ``n_steps · nfe_per_step`` evaluations; no accept/reject counts."""
    batch, dev = x.shape[0], x.device
    zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return SolveResult(
        x=x, nfe=torch.full((batch,), n_steps * nfe_per_step, dtype=torch.int32,
                            device=dev),
        iterations=torch.tensor(n_steps, dtype=torch.int32, device=dev),
        accepted=zeros, rejected=zeros)


def fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """fp32 a·b + c rounded once, as a fused multiply-add: the product of
    two fp32 values is exact in fp64, and so is the sum at the grid's
    magnitudes."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def tweedie_tail(sde: SDE, score_fn: Callable, x: Tensor) -> Tensor:
    """The paper's final denoising step at t = t_eps (one score evaluation)."""
    t = torch.full((x.shape[0],), sde.t_eps, dtype=torch.float32, device=x.device)
    return sde.tweedie_denoise(x, score_fn(x, t))


def get_solver(name: str) -> Callable[..., Any]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver '{name}'; available: {sorted(_REGISTRY)}") from None


def available_solvers():
    return sorted(_REGISTRY)
