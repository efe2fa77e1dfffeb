"""Observability layer (DESIGN.md §15); port of ``repro/observability``:
on-device solver telemetry, serve-loop span tracing, a metrics registry
with JSON and Prometheus export, and quality-proxy gauges.

Everything is off by default and leaves the solve as it was when off:
the telemetry ring rides ``SolverCarry.telemetry`` (None by default),
the tracer defaults to a no-op singleton, and the metrics registry only
holds counters the serve loop keeps anyway.
"""

from repro_torch.observability.metrics import MetricsRegistry
from repro_torch.observability.quality import (
    dynamics_consistency,
    env_step_mean,
    feature_moments,
    frechet_from_moments,
    proxy_fid,
    random_feature_extractor,
)
from repro_torch.observability.telemetry import (
    StepTelemetry,
    init_telemetry,
    record_step,
    telemetry_history,
)
from repro_torch.observability.tracing import (
    NULL_TRACER,
    NullTracer,
    StageTracer,
    profiler_annotation,
)

__all__ = [
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "StageTracer",
    "StepTelemetry",
    "dynamics_consistency",
    "env_step_mean",
    "feature_moments",
    "frechet_from_moments",
    "init_telemetry",
    "profiler_annotation",
    "proxy_fid",
    "random_feature_extractor",
    "record_step",
    "telemetry_history",
]
