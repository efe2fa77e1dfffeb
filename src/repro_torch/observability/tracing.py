"""Serve-loop span tracing (DESIGN.md §15); port of
``repro/observability/tracing.py``.

Monotonic-clock spans over the batcher's admission / solve / delivery
stages, plus profiler annotations around the device work. A span is a
``{name, start, end, duration_s, attrs}`` dict on an injectable clock;
the structure that matters (request ids through compaction, per-stage
latency distributions) lives in the attrs the serve loop attaches.
``NULL_TRACER`` is the default no-op: its ``span`` yields without
recording and reads no clock.

``profiler_annotation`` is ``torch.profiler.record_function`` (the
range shows in a ``torch.profiler`` trace), plus an NVTX range when the
device is CUDA, where the reference opens a ``jax.profiler`` annotation.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Any, Callable, Dict, List, Optional

import torch

#: log-spaced latency bucket upper bounds (seconds) for the per-stage
#: histograms; the final implicit bucket is +Inf
LATENCY_BUCKETS_S = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0,
)


class StageTracer:
    """Span recorder: ``with tracer.span("serve/solve", window=3): ...``.

    Spans nest freely (the record is a flat list ordered by end time);
    attrs must be JSON-serialisable.
    """

    #: False only on the null tracer: the serve loop keys optional extras
    #: (profiler annotations) on this flag
    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock if clock is not None else time.monotonic
        self.spans: List[Dict[str, Any]] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        rec: Dict[str, Any] = {"name": name, "start": self.clock(), "attrs": attrs}
        try:
            yield rec
        finally:
            rec["end"] = self.clock()
            rec["duration_s"] = rec["end"] - rec["start"]
            self.spans.append(rec)

    def stage_histograms(self) -> Dict[str, Dict[str, Any]]:
        """Per-stage latency histograms over the recorded spans: count /
        total / mean / max and log-spaced bucket counts
        (``LATENCY_BUCKETS_S`` bounds, final bucket +Inf)."""
        out: Dict[str, Dict[str, Any]] = {}
        for s in self.spans:
            h = out.setdefault(s["name"], {
                "count": 0, "total_s": 0.0, "max_s": 0.0,
                "buckets": [0] * (len(LATENCY_BUCKETS_S) + 1),
            })
            d = float(s["duration_s"])
            h["count"] += 1
            h["total_s"] += d
            h["max_s"] = max(h["max_s"], d)
            h["buckets"][bisect.bisect_left(LATENCY_BUCKETS_S, d)] += 1
        for h in out.values():
            h["mean_s"] = h["total_s"] / h["count"]
        return out

    def to_json(self) -> Dict[str, Any]:
        """Every span plus the per-stage histograms (bucket bounds
        included, so the record describes itself)."""
        return {
            "spans": list(self.spans),
            "stage_histograms": self.stage_histograms(),
            "bucket_bounds_s": list(LATENCY_BUCKETS_S),
        }


class NullTracer(StageTracer):
    """The no-op default: ``span`` records nothing and reads no clock."""

    enabled = False

    def __init__(self):
        super().__init__(clock=lambda: 0.0)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        yield {"name": name, "attrs": attrs}


#: shared no-op instance (stateless, safe to share across batchers)
NULL_TRACER = NullTracer()


@contextlib.contextmanager
def profiler_annotation(name: str, step: Optional[int] = None, device=None):
    """A profiler range for one stage: ``torch.profiler.record_function``
    named ``name`` (``name#step`` with a step number, so a trace groups a
    stage's windows), and an NVTX range of the same name when ``device``
    is a CUDA device. Both cost next to nothing without a profiler."""
    label = name if step is None else f"{name}#{int(step)}"
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
