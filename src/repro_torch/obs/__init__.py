"""Runtime observability of the port (counterpart of ``repro.obs``):
injectable clocks (``obs.clock``), nested spans with device-bracketed
timing (``obs.trace``), counters/gauges/histograms and the residency
sampler (``obs.metrics``), live job progress (``obs.progress``), the
JSONL and Chrome trace exporters (``obs.export``), trace analytics
(``obs.timeline``: per-phase self time, critical path, the overlap audit
of a pipelined and a serialized run, ``psum_overlap``) and live telemetry
(``obs.telemetry``: Prometheus text, the ``/metrics``, ``/healthz`` and
``/progress`` server, the ``prometheus`` exporter)."""
from .clock import MONOTONIC, Clock, FakeClock, MonotonicClock, now
from .export import (ChromeTraceExporter, JsonlExporter, exporter_names,
                     get_exporter, register_exporter)
from .metrics import (Counter, Gauge, Histogram, MeteredSource,
                      MetricsRegistry, live_device_bytes)
from .progress import ProgressReporter
from .telemetry import PrometheusExporter, TelemetryServer, prometheus_text
from .timeline import PhaseStat, Timeline, TSpan, overlap_report
from .trace import Span, Tracer, current_tracer, deep_tracing, tracing

__all__ = [
    "Clock", "MonotonicClock", "FakeClock", "MONOTONIC", "now",
    "Span", "Tracer", "tracing", "current_tracer", "deep_tracing",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "live_device_bytes", "MeteredSource", "ProgressReporter",
    "JsonlExporter", "ChromeTraceExporter", "register_exporter",
    "get_exporter", "exporter_names",
    "Timeline", "TSpan", "PhaseStat", "overlap_report",
    "TelemetryServer", "prometheus_text", "PrometheusExporter",
]
