"""Plain version of the WHILE-node driver: the reference's
``events_pending``, the two nested loop conditions of its
``solve_chunk`` and ``solve_horizons`` (``repro/core/solvers/
adaptive.py``) as P2 evaluates them, and the driver's loop, eager.

Used on the CPU, and by nothing on the card, where the loop is a CUDA
graph (``ops.WhileDriver``) that reads nothing back between units. This
loop reads the masks on the host after every unit.
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def events_pending(done: Tensor, occupied: Tensor, *, wait_all: bool = False) -> Tensor:
    """0-d bool: an occupied slot has converged (``wait_all``: some slot is
    occupied and none still runs)."""
    running = occupied & ~done
    if wait_all:
        return occupied.any() & ~running.any()
    return (occupied & done).any()


def horizon_cond(occupied: Tensor, done: Tensor, iterations: Tensor, state: Tensor, *,
                 wait_all: bool, horizon: int, max_iters: int, max_horizons: int,
                 first: bool) -> bool:
    """P2: whether the next unit runs, with ``state`` ← [event, n, u,
    units] in place (``ops.STATE``). ``first`` is the evaluation before any
    unit (n = u = units = 0); otherwise a unit just ran (u and units + 1).

    Inside a horizon the next unit runs while ``solve_chunk``'s condition
    holds: some row not done (the reference's ``any(t > t_eps + 1e-12)``),
    u < ``horizon`` and ``iterations`` < ``max_iters``. Where it fails (and
    before the first unit) the horizon is over, n + 1 (not on ``first``),
    u = 0, and ``solve_horizons``' condition decides: some occupied row
    running, no event, n < ``max_horizons``. If that holds but the new
    horizon's inner condition already fails (the budget is spent), the
    reference runs empty horizons to ``max_horizons``: n becomes
    ``max_horizons`` and nothing more runs."""
    event = bool(events_pending(done, occupied, wait_all=wait_all))
    running = bool((occupied & ~done).any())
    inner = bool((~done).any()) and int(iterations) < max_iters
    n, u, units = (0, 0, 0) if first else (int(state[1]), int(state[2]) + 1, int(state[3]) + 1)
    go = not first and inner and u < horizon
    if not go:
        n, u = n + (not first), 0
        go = running and not event and n < max_horizons
        if go and not (inner and horizon > 0):
            n, go = max_horizons, False
    state.copy_(torch.tensor([int(event), n, u, units], dtype=torch.int32))
    return go


def solve_horizons(unit: Callable, carry, occupied: Tensor, *, horizon: int, max_iters: int,
                   max_horizons: int, wait_all: bool = False, masks: Callable | None = None):
    """Run ``unit(carry) -> carry`` while P2 (``horizon_cond``) says so: the
    reference's ``solve_horizons`` over ``solve_chunk`` chunks of at most
    ``horizon`` units, until an event is pending, no occupied sample runs,
    or ``max_horizons`` horizons ran. Returns (carry, event at exit,
    horizons run, units run). ``masks(carry) -> (occupied, done)``
    replaces the pair the conditions read (under a mesh: the whole mesh's
    flags as two virtual slots, ``adaptive.MeshFlags.masks``); the budget
    is read from ``carry.iterations``."""
    masks = masks or (lambda c: (occupied, c.done))
    state = torch.zeros(4, dtype=torch.int32)

    def cond(first: bool) -> bool:
        occ, done = masks(carry)
        return horizon_cond(occ.cpu(), done.cpu(), carry.iterations.cpu(), state,
                            wait_all=wait_all, horizon=horizon, max_iters=max_iters,
                            max_horizons=max_horizons, first=first)

    go = cond(True)
    while go:
        carry = unit(carry)
        go = cond(False)
    return carry, bool(state[0]), int(state[1]), int(state[3])
