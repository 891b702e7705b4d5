"""Telemetry of the port: per-request tracing, the metric registry, the
profiler hooks (the JAX package's ``obs/``; docs/DESIGN.md §13 has the
span taxonomy and the metric names), and the phase helper the JAX package
does not have (``phases.Marks``): the one way the port marks the stages of
its captured search chunks (timing events recorded as nodes of the CUDA
graph, read after the sync the search makes anyway) and the phases of a
serving round and of a search on the host (spans of the tracer, site
``runtime`` or ``engine``, each inside a ``torch.profiler``
``record_function`` range ``repro/<phase>``). Everything it marks is
taken only while the owner's tracer is on: an engine with a live tracer
(``ExpansionEngine.set_tracer``) keeps a timed program beside each untimed
one, and a runtime keeps its round counters whatever the tracer."""
from repro_torch.obs.phases import Marks
from repro_torch.obs.profile import annotate, profile_trace
from repro_torch.obs.registry import DEFAULT_BUCKETS, Metric, Registry
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   attribution, format_trace)

__all__ = [
    "Marks", "annotate", "profile_trace",
    "DEFAULT_BUCKETS", "Metric", "Registry",
    "NULL_TRACER", "NullTracer", "Span", "Tracer",
    "attribution", "format_trace",
]
