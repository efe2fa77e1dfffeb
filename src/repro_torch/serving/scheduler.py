"""Serving-stage policies (DESIGN.md §14); port of the policy half of
``repro/serving/scheduler.py``: pluggable admission ordering (FIFO,
earliest-deadline-first within priority bands, with aging) and the
per-class delivery accounting stage, shared with the diffusion batcher.

The serve loop runs admission → solve → delivery. The solve stage is the
device step; these classes are the host-side halves. They are duck-typed
over request objects with ``priority`` (int band, lower = more urgent),
``deadline_at`` (absolute clock time or None), ``_submit_t``
(submission clock time) and ``uid``.

Not ported: the reference's ``ContinuousBatcher`` (scheduler.py:232),
the LM decode scheduler, waits for ROADMAP A12. It refuses SSM mixers
(scheduler.py:238–243), because a slot's SSM state cannot be masked
after the fact, and mamba2-2.7b is the only language model the port
has.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Deque, Dict, List, Optional


class AdmissionPolicy:
    """Admission stage: choose which queued requests take free slots.

    The base policy is FIFO — pop in submission order — which preserves
    the pre-policy batcher behaviour exactly (and is what the bitwise
    serving-identity gates pin). ``select`` removes the chosen requests
    from ``queue`` and returns them in seating order; the caller assigns
    them to free slots lowest-index first.
    """

    def select(self, queue: Deque, n_free: int, now: float) -> List:
        chosen = []
        while queue and len(chosen) < n_free:
            chosen.append(queue.popleft())
        return chosen


#: explicit name for the default stage (reads better at call sites)
class FifoAdmission(AdmissionPolicy):
    pass


@dataclasses.dataclass
class EdfPriorityAdmission(AdmissionPolicy):
    """Earliest-deadline-first within priority bands (DESIGN.md §14).

    Ordering key: (effective priority band, deadline, submission time,
    uid) — bands are never inverted, and within a band the request whose
    deadline expires soonest is seated first (no-deadline requests sort
    after every deadlined one in their band; submission time breaks
    ties, keeping the policy FIFO among equals).

    ``aging_s`` is the anti-starvation lever: a request's effective band
    drops by one for every ``aging_s`` seconds it has waited, without a
    floor — so under a saturating flood of urgent short-deadline
    traffic, any waiting request eventually occupies a band *below*
    every fresh arrival and must be seated. None disables aging (pure
    static bands; a saturated top band then starves lower ones — the
    property suite demonstrates both behaviours).
    """

    aging_s: Optional[float] = None

    def order_key(self, req, now: float):
        band = req.priority
        if self.aging_s is not None and self.aging_s > 0:
            band -= int(max(0.0, now - req._submit_t) / self.aging_s)
        deadline = math.inf if req.deadline_at is None else req.deadline_at
        return (band, deadline, req._submit_t, req.uid)

    def select(self, queue: Deque, n_free: int, now: float) -> List:
        ranked = sorted(queue, key=lambda r: self.order_key(r, now))
        chosen = ranked[:n_free]
        for r in chosen:
            queue.remove(r)
        return chosen


@dataclasses.dataclass
class TierStats:
    """Per-tolerance-class delivery counters (DESIGN.md §14), accumulated
    at the batcher's ``_d2h`` accounting seam — the NFE numbers come from
    the same pulled (B,) bookkeeping the waste accounting reads, never an
    extra transfer."""

    delivered: int = 0
    nfe_total: int = 0
    deadline_misses: int = 0
    deadline_met: int = 0
    wait_s_total: float = 0.0  # submission → admission queue wait

    @property
    def mean_nfe(self) -> float:
        return self.nfe_total / self.delivered if self.delivered else 0.0

    def as_dict(self) -> dict:
        return {
            "delivered": self.delivered,
            "mean_nfe": self.mean_nfe,
            "deadline_misses": self.deadline_misses,
            "deadline_met": self.deadline_met,
            "mean_wait_s": (self.wait_s_total / self.delivered
                            if self.delivered else 0.0),
        }


class TierAccounting:
    """Delivery stage: per-class NFE + deadline-miss/violation counters.

    ``on_deliver`` runs once per retired request, right after the
    retired rows crossed ``_d2h`` — the single counted device→host seam
    — so tier accounting adds zero transfers. A delivered-late request
    counts as a miss (``deliver_t > deadline_at``); requests without a
    deadline count under ``deadline_met``.

    ``bind(registry)`` feeds the same deliveries into a shared
    ``MetricsRegistry`` (DESIGN.md §15) as tier-labeled counters —
    ``serve_delivered_total`` / ``serve_tier_nfe_total`` /
    ``serve_deadline_misses_total`` / ``serve_deadline_met_total`` plus
    a ``serve_queue_wait_seconds`` histogram. This is the seam
    unification: before §15, deadline misses were counted here (at
    delivery) while NFE-waste was folded at a different host visit, and
    nothing asserted the two ledgers agreed; bound to one registry,
    both stages write the same books and the observability tests pin
    them to the device-side counters.
    """

    def __init__(self, registry=None):
        self.stats: Dict[str, TierStats] = {}
        self.registry = registry

    def bind(self, registry) -> None:
        """Adopt the serve loop's registry unless one was pinned at
        construction (idempotent; the batcher calls this so a default
        TierAccounting shares the batcher's books)."""
        if self.registry is None:
            self.registry = registry

    def on_deliver(self, req, now: float) -> None:
        name = tier_name(req)
        s = self.stats.setdefault(name, TierStats())
        s.delivered += 1
        s.nfe_total += int(req.nfe)
        wait = max(0.0, req._seat_t - req._submit_t)
        s.wait_s_total += wait
        missed = req.deadline_at is not None and now > req.deadline_at
        req.deadline_missed = missed
        if missed:
            s.deadline_misses += 1
        else:
            s.deadline_met += 1
        if self.registry is not None:
            m = self.registry
            m.counter("serve_delivered_total", tier=name).inc()
            m.counter("serve_tier_nfe_total", tier=name).inc(int(req.nfe))
            m.counter("serve_deadline_misses_total", tier=name).inc(missed)
            m.counter("serve_deadline_met_total", tier=name).inc(not missed)
            m.histogram("serve_queue_wait_seconds", tier=name).observe(wait)


def tier_name(req) -> str:
    """A request's tolerance-class name for accounting: the tier's
    ``name`` (preset string or ToleranceClass), or ``"default"`` for
    untiered requests riding the server's static config."""
    tier = getattr(req, "tier", None)
    if tier is None:
        return "default"
    return tier if isinstance(tier, str) else tier.name
