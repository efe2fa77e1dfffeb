"""Metrics registry (DESIGN.md §15); port of
``repro/observability/metrics.py``: counters, gauges and histograms
with JSON and Prometheus text-format export, standard library only.

Every number the serve loop keeps is a named, optionally labelled
series, so the delivery stage's per-tier books and the serve loop's
waste books write one ledger and can be asserted consistent. Names
follow Prometheus conventions (``*_total`` for counters, units in the
name); labels are keyword arguments:
``registry.counter("serve_delivered_total", tier="draft").inc()``.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.observability.tracing import LATENCY_BUCKETS_S

#: (name, sorted label items): one series per unique pair
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counters are monotone; inc({n})")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bucket histogram; exported cumulatively (Prometheus ``le``)."""

    __slots__ = ("bounds", "buckets", "total", "count")

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS_S):
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)  # final = +Inf
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.buckets[bisect.bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1


class MetricsRegistry:
    """Get-or-create registry of named, labelled metric series."""

    def __init__(self):
        self._counters: Dict[_Key, Counter] = {}
        self._gauges: Dict[_Key, Gauge] = {}
        self._hists: Dict[_Key, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        return self._counters.setdefault(_key(name, labels), Counter())

    def gauge(self, name: str, **labels) -> Gauge:
        return self._gauges.setdefault(_key(name, labels), Gauge())

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        k = _key(name, labels)
        if k not in self._hists:
            self._hists[k] = Histogram() if bounds is None else Histogram(bounds)
        return self._hists[k]

    def value(self, name: str, **labels) -> float:
        """One series (counter or gauge) by exact name and labels."""
        k = _key(name, labels)
        if k in self._counters:
            return self._counters[k].value
        if k in self._gauges:
            return self._gauges[k].value
        raise KeyError(f"no metric series {_series(k)}")

    def total(self, name: str) -> float:
        """A counter summed over all its label sets."""
        return sum(c.value for (n, _), c in self._counters.items() if n == name)

    # -- export ---------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "counters": {_series(k): c.value for k, c in sorted(self._counters.items())},
            "gauges": {_series(k): g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                _series(k): {"bounds": list(h.bounds), "buckets": list(h.buckets),
                             "count": h.count, "sum": h.total}
                for k, h in sorted(self._hists.items())
            },
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4): one ``# TYPE`` line
        per metric name; cumulative ``le`` buckets plus ``_sum`` and
        ``_count`` for histograms."""
        lines = []
        typed = set()

        def type_line(name, kind):
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for k, c in sorted(self._counters.items()):
            type_line(k[0], "counter")
            lines.append(f"{_series(k)} {c.value}")
        for k, g in sorted(self._gauges.items()):
            type_line(k[0], "gauge")
            lines.append(f"{_series(k)} {g.value}")
        for (name, labels), h in sorted(self._hists.items()):
            type_line(name, "histogram")
            cum = 0
            for bound, n in zip(h.bounds, h.buckets):
                cum += n
                lk = labels + (("le", repr(float(bound))),)
                lines.append(f"{_series((name + '_bucket', lk))} {cum}")
            lk = labels + (("le", "+Inf"),)
            lines.append(f"{_series((name + '_bucket', lk))} {h.count}")
            lines.append(f"{_series((name + '_sum', labels))} {h.total}")
            lines.append(f"{_series((name + '_count', labels))} {h.count}")
        return "\n".join(lines) + "\n"
