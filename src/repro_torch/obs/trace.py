"""Nested runtime spans with device-bracketed timing (counterpart of
``repro.obs.trace``).

A :class:`Tracer` records a tree of :class:`Span` s — name, wall-clock
interval, attributes, and point-in-time events — plus a
:class:`~repro_torch.obs.metrics.MetricsRegistry`, and hands everything to
pluggable exporters (``repro_torch.obs.export``) when the trace finishes.

Spans are opened and closed in HOST code around the device work.  PyTorch
returns before the card has finished, so device work is timed by
BRACKETING: register the output tensors on the span
(``span.block_on(out)``) and the tracer synchronizes the CUDA stream of
each before reading the closing timestamp, so the span covers dispatch +
device execution.

Ambient usage (zero overhead when no tracer is installed; every helper
returns a shared no-op object then):

    from repro_torch.obs import trace as obs_trace

    with obs_trace.tracing(chrome="trace.json"):
        engine.run()                     # engines pick the tracer up

    # inside an engine:
    with obs_trace.span("serve.prefill_chunk", start=s) as sp:
        logits, caches = prefill_chunk(...)
        sp.block_on(logits)              # close waits for the device

``deep=True`` asks engines that support it for their step-at-a-time
profiling schedule (the serving engine brackets each chunked-prefill span
on the device).  It is a PROFILING mode: never leave it on in a
latency-sensitive loop.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Optional

import torch

from .clock import Clock, MONOTONIC
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Span", "Tracer", "tracing", "current_tracer", "deep_tracing",
           "span", "event", "counter", "gauge", "histogram", "attributes"]


@dataclass
class Span:
    """One timed interval.  ``t1`` is None while the span is open;
    ``events`` are (name, ts, attrs) points inside the interval."""
    name: str
    t0: float
    depth: int
    index: int
    track: str = "main"
    t1: Optional[float] = None
    attrs: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    _pending: list = field(default_factory=list, repr=False)

    @property
    def dur(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, *, ts: Optional[float] = None, **attrs):
        self.events.append((name, ts, dict(attrs)))

    def block_on(self, value) -> "Span":
        """Register ``value`` (a tensor, or nested lists, tuples and dicts
        of tensors) whose CUDA streams are synchronized before the closing
        timestamp is read — the device-bracketed timing contract."""
        self._pending.append(value)
        return self


class _NullSpan:
    """The no-tracer fast path: every instrumentation call is a no-op
    attribute access on this shared singleton."""

    def set(self, **attrs):
        return self

    def event(self, name, *, ts=None, **attrs):
        pass

    def block_on(self, value):
        return self


class _NullInstrument:
    """No-op Counter/Gauge/Histogram stand-in."""

    def add(self, v: float = 1.0):
        pass

    def set(self, v: float, *, ts=None):
        pass

    def observe(self, v: float):
        pass


def _synchronize(value) -> None:
    """Wait for the current CUDA stream of every CUDA tensor in ``value``
    (the counterpart of ``jax.block_until_ready``)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.current_stream(value.device).synchronize()
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _synchronize(v)


NULL_SPAN = _NullSpan()
_NULL_INSTRUMENT = _NullInstrument()


@contextlib.contextmanager
def _null_span_cm():
    yield NULL_SPAN


class Tracer:
    """Span recorder + metrics registry + exporter fan-out.

    ``clock`` is injectable (``FakeClock`` in tests); ``deep`` opts
    engines into their step-at-a-time profiling schedules (module
    docstring).  Spans are exception-safe: a span closed by an error
    still records its interval (with ``error=...`` attrs) and still
    exports.
    """

    def __init__(self, *, clock: Clock = MONOTONIC, deep: bool = False,
                 exporters=()):
        self.clock = clock
        self.deep = deep
        self.exporters = list(exporters)
        self.metrics = MetricsRegistry(clock=clock)
        self.spans: list[Span] = []          # finished, in closing order
        self._stack: list[Span] = []
        self._n = 0
        self._defaults: list[dict] = []      # bind() attribute stack
        self.t_origin: Optional[float] = None

    # ------------------------------------------------------------- spans
    @contextlib.contextmanager
    def bind(self, **attrs):
        """Default attributes for every span started in this dynamic
        extent (explicit span attrs win on key collision).  This is how
        a job stamps its fingerprint onto all descendant spans without
        threading an id through every engine API."""
        self._defaults.append(dict(attrs))
        try:
            yield
        finally:
            self._defaults.pop()

    def start(self, name: str, **attrs) -> Span:
        t0 = self.clock()
        if self.t_origin is None:
            self.t_origin = t0
        merged: dict = {}
        for d in self._defaults:
            merged.update(d)
        merged.update(attrs)
        sp = Span(name=name, t0=t0, depth=len(self._stack), index=self._n,
                  attrs=merged)
        self._n += 1
        self._stack.append(sp)
        return sp

    def end(self, sp: Span) -> Span:
        if sp._pending:
            _synchronize(sp._pending)
            sp._pending = []
        sp.t1 = self.clock()
        # Tolerate out-of-order closes (an engine that leaks a span must
        # not corrupt the rest of the trace): pop through to sp.
        while self._stack:
            top = self._stack.pop()
            if top is sp:
                break
            top.t1 = sp.t1
            top.attrs.setdefault("error", "span leaked (closed by child)")
            self.spans.append(top)
        self.spans.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = self.start(name, **attrs)
        try:
            yield sp
        except BaseException as e:
            sp.set(error=f"{type(e).__name__}: {e}")
            raise
        finally:
            self.end(sp)

    def event(self, name: str, **attrs):
        """Point event on the current span (or a root-level zero-length
        span when none is open)."""
        ts = self.clock()
        if self._stack:
            self._stack[-1].event(name, ts=ts, **attrs)
        else:
            sp = self.start(name, **attrs)
            sp.t0 = sp.t1 = ts           # zero-length at the single read
            self._stack.pop()
            self.spans.append(sp)

    # ------------------------------------------------------------ metrics
    def counter(self, name: str) -> Counter:
        return self.metrics.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.metrics.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.metrics.histogram(name)

    # ------------------------------------------------------------- export
    def finish(self) -> None:
        """Close any leaked spans and run every exporter."""
        while self._stack:
            self.end(self._stack[-1])
        for ex in self.exporters:
            ex.export(self)


# ---------------------------------------------------------------------------
# Ambient tracer: contextvar + no-op fallbacks
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_tracer", default=None)


def current_tracer() -> Optional[Tracer]:
    return _CURRENT.get()


def deep_tracing() -> bool:
    """True when an ambient tracer with ``deep=True`` is installed —
    engines consult this to switch into their profiling schedules."""
    tr = _CURRENT.get()
    return tr is not None and tr.deep


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None, *, chrome=None, jsonl=None,
            clock: Clock = MONOTONIC, deep: bool = False):
    """Install a tracer as the ambient one for the dynamic extent.

    Either pass a prebuilt :class:`Tracer`, or let this build one with
    the named exporters: ``chrome=path`` (Chrome trace-event JSON, load
    in Perfetto / chrome://tracing) and/or ``jsonl=path`` (one event per
    line).  The trace is finished (and exported) on exit — including
    exceptional exit, so a crashed run still leaves its trace behind.
    """
    if tracer is None:
        from .export import ChromeTraceExporter, JsonlExporter
        exporters = []
        if chrome is not None:
            exporters.append(ChromeTraceExporter(chrome))
        if jsonl is not None:
            exporters.append(JsonlExporter(jsonl))
        tracer = Tracer(clock=clock, deep=deep, exporters=exporters)
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)
        tracer.finish()


def span(name: str, **attrs):
    """Ambient span: a real span on the current tracer, or a shared
    no-op context when tracing is off."""
    tr = _CURRENT.get()
    return _null_span_cm() if tr is None else tr.span(name, **attrs)


def attributes(**attrs):
    """Ambient :meth:`Tracer.bind`: default attrs for every span in the
    extent, or a shared no-op context when tracing is off."""
    tr = _CURRENT.get()
    return _null_span_cm() if tr is None else tr.bind(**attrs)


def event(name: str, **attrs) -> None:
    tr = _CURRENT.get()
    if tr is not None:
        tr.event(name, **attrs)


def counter(name: str):
    tr = _CURRENT.get()
    return _NULL_INSTRUMENT if tr is None else tr.counter(name)


def gauge(name: str):
    tr = _CURRENT.get()
    return _NULL_INSTRUMENT if tr is None else tr.gauge(name)


def histogram(name: str):
    tr = _CURRENT.get()
    return _NULL_INSTRUMENT if tr is None else tr.histogram(name)
