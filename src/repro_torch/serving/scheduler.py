"""Serving stages; port of ``repro/serving/scheduler.py``: pluggable
admission ordering (FIFO, earliest-deadline-first within priority bands,
with aging) and the per-class delivery accounting stage, shared with the
diffusion batcher (DESIGN.md §14); and ``ContinuousBatcher``, greedy
continuous-batching decode of a language model over a fixed slot batch.

The serve loop runs admission → solve → delivery. The solve stage is the
device step; these classes are the host-side halves. They are duck-typed
over request objects with ``priority`` (int band, lower = more urgent),
``deadline_at`` (absolute clock time or None), ``_submit_t``
(submission clock time) and ``uid``.

``ContinuousBatcher`` (reference :232–336) seats queued ``Request``s in
free slots, replays each prompt token by token, then decodes greedily
until EOS or ``max_new_tokens``; a retired slot takes the next request
at once. Slots share one KV cache whose positions advance in lockstep;
a slot sees only the positions from its request's start on
(``start_pos``), so nothing leaks through attention. It refuses Mamba2
("M") mixers, whose state cannot be masked after the fact, and codebook
heads, as the reference does, and cross-attention ("X") mixers, since
the reference's batcher passes no image embeddings. It serves mixture-of-experts ("E")
models, whose requests are not isolated: a decode step routes the slots'
tokens as one group with a shared expert capacity, so a request's tokens
depend on its seatmates, as in the reference; free slots feed token 0
(reference :252), and those tokens take capacity too.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import init_decode_state
from repro_torch.models.config import ModelConfig


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


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (P,) int token ids
    max_new_tokens: int
    eos_id: Optional[int] = None
    # filled by the scheduler
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    remaining_prompt: Deque[int] = dataclasses.field(default_factory=deque)
    new_tokens: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


class ContinuousBatcher:
    """Greedy continuous-batching decode over a fixed slot batch, on
    ``device`` (the card unless the caller asks for the CPU).

    ``cache_len`` is the attention caches' length: the global step count
    (every step advances every slot's position) must stay below it for
    the global layers, as in the reference. With "E" layers a request's
    tokens depend on its seatmates (and on free slots' token 0) through
    the experts' capacity, as in the reference.

    On the card every step replays one CUDA graph of the serve step,
    captured at the first step (``launch.steps.GraphedServeStep``; the
    decode state stays in place across steps): ``captures`` and
    ``build_s`` report it (0 on the CPU, where the step is eager)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 cache_len: int = 256, device="cuda"):
        if cfg.num_codebooks != 1:
            raise ValueError("the scheduler serves one-codebook language models")
        if "X" in cfg.mixer_pattern:
            raise ValueError("the scheduler passes no image embeddings, so it does not serve "
                             "cross-attention ('X') models; serve them with "
                             "launch.serve.serve_batch(cross_embeds=)")
        if any(m == "M" for m in cfg.mixer_pattern):
            raise ValueError("continuous batching isolates slots by masking KV positions; "
                             "SSM state cannot be masked after the fact, so serve SSM "
                             "architectures in dedicated batches (launch.serve.serve_batch)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = [_Slot() for _ in range(slots)]
        self.n_slots = slots
        self.cache_len = cache_len
        self.state = init_decode_state(cfg, slots, cache_len, device=self.device)
        self.step_fn = make_serve_step(cfg, device=self.device)
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        # the token each slot feeds next step (0 for a free slot)
        self._next_input = np.zeros((slots,), np.int32)
        # the global step (the caches' length) and each slot's request start
        self._global_step = 0
        self._start_pos = np.zeros((slots,), np.int32)
        # occupancy: every step costs a slots-wide forward, occupied or not
        # (the decode-side analog of DiffusionBatcher's wasted NFE); the
        # sampled token feeds the next step, so a step reads the host once
        self.total_steps = 0
        self.useful_steps = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _assign_free_slots(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.free and self.queue:
                req = self.queue.popleft()
                slot.request = req
                slot.remaining_prompt = deque(int(t) for t in np.asarray(req.prompt))
                slot.new_tokens = 0
                self._next_input[i] = slot.remaining_prompt.popleft()
                # isolation: this slot sees only KV from its own request
                self._start_pos[i] = self._global_step

    def _advance_slot(self, i: int, sampled: int) -> None:
        slot = self.slots[i]
        req = slot.request
        if req is None:
            return
        if slot.remaining_prompt:
            # still prefilling by replay: ignore the sample, feed the prompt
            self._next_input[i] = slot.remaining_prompt.popleft()
            return
        req.output.append(sampled)
        slot.new_tokens += 1
        hit_eos = req.eos_id is not None and sampled == req.eos_id
        if slot.new_tokens >= req.max_new_tokens or hit_eos:
            req.done = True
            self.finished[req.uid] = req
            slot.request = None
            self._next_input[i] = 0
        else:
            self._next_input[i] = sampled

    @property
    def captures(self) -> int:
        """CUDA graphs the serve step captured (one a batcher on the card)."""
        return getattr(self.step_fn, "captures", 0)

    @property
    def build_s(self) -> float:
        """Host seconds the serve step's capture took."""
        return getattr(self.step_fn, "build_s", 0.0)

    @property
    def wasted_step_fraction(self) -> float:
        """Share of issued slot-steps that served free slots."""
        issued = self.n_slots * self.total_steps
        if issued == 0:
            return 0.0
        return 1.0 - self.useful_steps / issued

    def step(self) -> int:
        """One device step for all slots; returns the number of active slots."""
        self._assign_free_slots()
        active = sum(0 if s.free else 1 for s in self.slots)
        if active == 0:
            return 0
        self.total_steps += 1
        self.useful_steps += active
        batch = {"tokens": torch.from_numpy(self._next_input[:, None].copy()).to(self.device),
                 "start_pos": torch.from_numpy(self._start_pos.copy()).to(self.device)}
        next_tok, self.state = self.step_fn(self.params, batch, self.state)
        self._global_step += 1
        sampled = next_tok[:, 0].cpu().numpy()
        for i in range(self.n_slots):
            self._advance_slot(i, int(sampled[i]))
        return active

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Step until the queue and every slot are empty (or ``max_steps``);
        returns the finished requests by uid, in finishing order."""
        steps = 0
        while (self.queue or any(not s.free for s in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
