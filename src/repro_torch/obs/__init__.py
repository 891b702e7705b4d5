"""Telemetry of the port: per-request tracing, the metric registry and the
profiler hooks (the JAX package's ``obs/``; docs/DESIGN.md §13 has the
span taxonomy and the metric names)."""
from repro_torch.obs.profile import annotate, profile_trace
from repro_torch.obs.registry import DEFAULT_BUCKETS, Metric, Registry
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   attribution, format_trace)

__all__ = [
    "annotate", "profile_trace",
    "DEFAULT_BUCKETS", "Metric", "Registry",
    "NULL_TRACER", "NullTracer", "Span", "Tracer",
    "attribution", "format_trace",
]
