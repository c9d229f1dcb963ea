"""Unified observability for the port: metrics registry, span tracing,
live export (a copy of ``repro.obs`` that imports nothing of it; metric
names, labels and the Prometheus text are the same).
"""

from .metrics import (MetricsRegistry, Sample, get_registry,  # noqa: F401
                      set_registry)
from .trace import (Span, Tracer, get_tracer, request_tree,   # noqa: F401
                    set_tracer)
from .export import MetricsExporter, start_http_exporter      # noqa: F401

__all__ = [
    "MetricsRegistry", "Sample", "get_registry", "set_registry",
    "Span", "Tracer", "get_tracer", "set_tracer", "request_tree",
    "MetricsExporter", "start_http_exporter",
]
