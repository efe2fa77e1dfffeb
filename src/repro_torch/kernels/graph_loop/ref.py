"""Plain version of the device-resident driver: the reference's
``events_pending`` and ``solve_horizons`` (``repro/core/solvers/
adaptive.py``) as an eager Python loop, and P2's arithmetic.

Used on the CPU, and by nothing on the card, where the loop is a CUDA
graph (``ops.WhileDriver``) that reads nothing back between horizons.
This loop reads the predicate on the host before every horizon.
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


def horizon_cond(occupied: Tensor, done: Tensor, state: Tensor, *, wait_all: bool,
                 max_horizons: int, first: bool) -> bool:
    """P2: state ← [event, n] with n = 0 (``first``) or state[1] + 1, in
    place; returns the loop predicate running ∧ ¬event ∧ n < max."""
    n = 0 if first else int(state[1]) + 1
    event = bool(events_pending(done, occupied, wait_all=wait_all))
    running = bool((occupied & ~done).any())
    state.copy_(torch.tensor([int(event), n], dtype=torch.int32))
    return running and not event and n < max_horizons


def solve_horizons(horizon: Callable, carry, occupied: Tensor, *, max_horizons: int,
                   wait_all: bool = False, masks: Callable | None = None):
    """Run ``horizon(carry) -> carry`` (one sync-horizon chunk) until an
    event is pending, no occupied sample runs, or ``max_horizons`` ran.
    Returns (carry, event at exit, horizons run). ``masks(carry) ->
    (occupied, done)`` replaces the pair the condition reads (under a
    mesh: the whole mesh's flags as two virtual slots,
    ``adaptive.MeshFlags.masks``)."""
    masks = masks or (lambda c: (occupied, c.done))
    state = torch.zeros(2, dtype=torch.int32)

    def cond(first: bool) -> bool:
        occ, done = masks(carry)
        return horizon_cond(occ.cpu(), done.cpu(), state, wait_all=wait_all,
                            max_horizons=max_horizons, first=first)

    go = cond(True)
    while go:
        carry = horizon(carry)
        go = cond(False)
    return carry, bool(state[0]), int(state[1])
