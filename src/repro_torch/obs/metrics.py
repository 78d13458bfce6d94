"""Counters, gauges, and histograms (counterpart of ``repro.obs.metrics``).

A :class:`MetricsRegistry` is a named bag of instruments; the tracer owns
one (``repro_torch.obs.trace.Tracer.metrics``) so span timing and metric
samples share a clock and export together, but a registry also stands
alone.

Instruments:

  :class:`Counter`    monotonically increasing total (shed, quarantined,
                      timed-out requests).
  :class:`Gauge`      last-value-wins sample series with timestamps
                      (queue depth, slot occupancy) — the series exports
                      as Chrome-trace ``ph:"C"`` counter tracks.
  :class:`Histogram`  summary statistics (count/sum/min/max) of repeated
                      observations.

The reference's device-residency sampler (``live_device_bytes``,
``MeteredSource``) comes with the streaming slice.
"""
from __future__ import annotations

import math
from typing import Optional

from .clock import Clock, MONOTONIC

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic total.  ``add`` rejects negative increments eagerly."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def add(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name!r} is monotonic; "
                             f"got negative increment {v}")
        self.value += v

    def snapshot(self) -> dict:
        return {"type": "counter", "name": self.name, "value": self.value}


class Gauge:
    """Last-value-wins sample series; keeps (ts, value) pairs so the
    exporter can render the full track, not just the final sample."""

    def __init__(self, name: str, clock: Clock = MONOTONIC):
        self.name = name
        self._clock = clock
        self.samples: list[tuple[float, float]] = []

    def set(self, v: float, *, ts: Optional[float] = None) -> None:
        self.samples.append((self._clock() if ts is None else ts, float(v)))

    @property
    def value(self) -> Optional[float]:
        return self.samples[-1][1] if self.samples else None

    def snapshot(self) -> dict:
        return {"type": "gauge", "name": self.name, "value": self.value,
                "samples": len(self.samples)}


class Histogram:
    """Streaming summary of repeated observations (no bucket storage —
    count/sum/min/max/sumsq, enough for mean and variance)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.sumsq = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.sumsq += v * v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> dict:
        return {"type": "histogram", "name": self.name, "count": self.count,
                "sum": self.sum, "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
                "mean": self.mean}


class MetricsRegistry:
    """Named instruments, created on first use (``counter("x").add(1)``);
    re-requesting a name returns the same instrument, and requesting a
    name held by a different instrument kind is an eager error."""

    def __init__(self, clock: Clock = MONOTONIC):
        self._clock = clock
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, **kw)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(inst).__name__}, requested "
                             f"{cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, clock=self._clock)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def __iter__(self):
        return iter(self._instruments.values())

    def snapshot(self) -> list[dict]:
        return [inst.snapshot()
                for _, inst in sorted(self._instruments.items())]
