"""Trace exporters (counterpart of ``repro.obs.export``): a plugin
interface, not a configuration switch.

Following the floe ADR-0037 principle (multiple implementations exist →
plugin registry, so new backends never touch the core), an exporter is
any object with ``export(tracer)``; implementations register under a
name with :func:`register_exporter` and callers resolve them with
:func:`get_exporter` — adding an OTLP/Jaeger/whatever backend is one
registered class, zero changes here or in the tracer.

Two exporters ship in-tree:

  ``jsonl``   one JSON object per line (spans, then events, then metric
              snapshots) — grep/pandas-friendly, append-composable.
  ``chrome``  Chrome trace-event JSON (``ph:"X"`` complete spans,
              ``ph:"i"`` instants, ``ph:"C"`` counter tracks from gauge
              series).  Load the file in Perfetto (ui.perfetto.dev) or
              chrome://tracing.

Timestamps are rebased to the trace origin (first span start = 0) so
exported times are small, positive, and stable across runs regardless
of the host clock's epoch.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

from .metrics import Gauge

__all__ = ["register_exporter", "get_exporter", "exporter_names",
           "JsonlExporter", "ChromeTraceExporter"]

_EXPORTERS: dict[str, Callable] = {}


def register_exporter(name: str):
    """Class decorator: register an exporter factory under ``name``.
    Re-registering a name is an eager error (it would silently shadow a
    backend)."""
    def _do(cls):
        if name in _EXPORTERS:
            raise ValueError(f"duplicate exporter name {name!r}")
        _EXPORTERS[name] = cls
        return cls
    return _do


def get_exporter(name: str, *args, **kwargs):
    """Instantiate the exporter registered under ``name``."""
    if name not in _EXPORTERS:
        raise ValueError(f"unknown exporter {name!r}; registered: "
                         f"{sorted(_EXPORTERS)}")
    return _EXPORTERS[name](*args, **kwargs)


def exporter_names() -> list[str]:
    return sorted(_EXPORTERS)


def _rebase(tracer, t) -> float:
    origin = tracer.t_origin or 0.0
    return t - origin


@register_exporter("jsonl")
class JsonlExporter:
    """One JSON object per line.

    Line schemas (``type`` discriminates):
      span    {type, name, ts, dur, depth, index, attrs}
      event   {type, name, ts, span, attrs}
      metric  {type: "counter"|"gauge"|"histogram", name, ...snapshot}
    ``ts``/``dur`` are seconds from the trace origin.
    """

    def __init__(self, path):
        self.path = Path(path)

    def export(self, tracer) -> None:
        lines = []
        for sp in sorted(tracer.spans, key=lambda s: s.index):
            lines.append({"type": "span", "name": sp.name,
                          "ts": _rebase(tracer, sp.t0), "dur": sp.dur,
                          "depth": sp.depth, "index": sp.index,
                          "attrs": sp.attrs})
            for name, ts, attrs in sp.events:
                lines.append({"type": "event", "name": name,
                              "ts": None if ts is None
                              else _rebase(tracer, ts),
                              "span": sp.name, "attrs": attrs})
        lines.extend(tracer.metrics.snapshot())
        with open(self.path, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


@register_exporter("chrome")
class ChromeTraceExporter:
    """Chrome trace-event JSON, viewable in Perfetto.

    Spans become ``ph:"X"`` complete events (``ts``/``dur`` in
    microseconds — the format's unit), span events become thread-scoped
    instants (``ph:"i"``), and every gauge's sample series becomes a
    ``ph:"C"`` counter track.  All spans share one pid/tid so Perfetto
    nests them by interval containment, which matches the tracer's
    stack discipline.
    """

    PID = 1
    TID = 1

    def __init__(self, path):
        self.path = Path(path)

    def export(self, tracer) -> None:
        ev = [{"ph": "M", "pid": self.PID, "name": "process_name",
               "args": {"name": "repro"}}]
        us = 1e6
        for sp in sorted(tracer.spans, key=lambda s: s.index):
            ev.append({"ph": "X", "name": sp.name, "pid": self.PID,
                       "tid": self.TID,
                       "ts": _rebase(tracer, sp.t0) * us,
                       "dur": 0.0 if sp.dur is None else sp.dur * us,
                       "args": _jsonable(sp.attrs)})
            for name, ts, attrs in sp.events:
                ev.append({"ph": "i", "s": "t", "name": name,
                           "pid": self.PID, "tid": self.TID,
                           "ts": _rebase(tracer, sp.t0 if ts is None
                                         else ts) * us,
                           "args": _jsonable(attrs)})
        for inst in tracer.metrics:
            if isinstance(inst, Gauge):
                for ts, v in inst.samples:
                    ev.append({"ph": "C", "name": inst.name,
                               "pid": self.PID,
                               "ts": _rebase(tracer, ts) * us,
                               "args": {"value": v}})
        payload = {"traceEvents": ev, "displayTimeUnit": "ms",
                   "otherData": {"counters": [
                       c.snapshot() for c in tracer.metrics
                       if not isinstance(c, Gauge)]}}
        self.path.write_text(json.dumps(payload))


def _jsonable(attrs: dict) -> dict:
    """Chrome viewers choke on non-JSON values; stringify anything
    exotic rather than dropping it."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out
