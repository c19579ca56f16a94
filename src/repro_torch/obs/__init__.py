"""Observability control plane: metrics registry + time series,
Prometheus scrape endpoint, request lifecycle tracing, overload
detection, flight recorder + post-mortem dumps, numerical-health
instruments.  See ``docs/observability.md`` for the metric glossary
and wiring quickstarts.

The port's own copy of the reference's ``obs`` package (it is pure
Python: stdlib and numpy), so metric names, label sets and the rendered
Prometheus text are the reference's byte for byte."""
from repro_torch.obs.flight import NULL_FLIGHT, FlightRecorder, NullFlight
from repro_torch.obs.health import HealthMonitor
from repro_torch.obs.histogram import (DEFAULT_LATENCY_BUCKETS_S, bucket_index,
                                 percentile, quantile_from_counts, summarize)
from repro_torch.obs.overload import OverloadDetector, SustainedThresholdDetector
from repro_torch.obs.prometheus import MetricsServer, maybe_serve, render
from repro_torch.obs.registry import (NULL, CardinalityError, Counter, Gauge,
                                Histogram, MetricsRegistry, NullRegistry)
from repro_torch.obs.tracing import (RequestTrace, Span, Tracer,
                               trace_from_request)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_S", "bucket_index", "percentile",
    "quantile_from_counts", "summarize",
    "NULL", "CardinalityError", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NullRegistry",
    "MetricsServer", "maybe_serve", "render",
    "RequestTrace", "Span", "Tracer", "trace_from_request",
    "OverloadDetector", "SustainedThresholdDetector",
    "NULL_FLIGHT", "FlightRecorder", "NullFlight", "HealthMonitor",
]
