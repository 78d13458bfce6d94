"""Runtime observability of the port (counterpart of ``repro.obs``):
injectable clocks (``obs.clock``), nested spans with device-bracketed
timing (``obs.trace``), counters/gauges/histograms and the residency
sampler (``obs.metrics``), live job progress (``obs.progress``) and the
JSONL and Chrome trace exporters (``obs.export``).  The reference's
``timeline`` and ``telemetry`` (the Prometheus server) come later
(ROADMAP Queue A item 2)."""
from .clock import MONOTONIC, Clock, FakeClock, MonotonicClock, now
from .export import (ChromeTraceExporter, JsonlExporter, exporter_names,
                     get_exporter, register_exporter)
from .metrics import (Counter, Gauge, Histogram, MeteredSource,
                      MetricsRegistry, live_device_bytes)
from .progress import ProgressReporter
from .trace import Span, Tracer, current_tracer, deep_tracing, tracing

__all__ = [
    "Clock", "MonotonicClock", "FakeClock", "MONOTONIC", "now",
    "Span", "Tracer", "tracing", "current_tracer", "deep_tracing",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "live_device_bytes", "MeteredSource", "ProgressReporter",
    "JsonlExporter", "ChromeTraceExporter", "register_exporter",
    "get_exporter", "exporter_names",
]
