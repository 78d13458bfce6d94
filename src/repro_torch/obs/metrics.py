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

The device-residency sampler, ``live_device_bytes`` and
``MeteredSource``, is the one measurement path of device residency: the
streamed ID's ``device.live_bytes`` gauge, ``bench_stream`` and
``analysis.residency`` read it.
"""
from __future__ import annotations

import math
from typing import Optional

from .clock import Clock, MONOTONIC

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "live_device_bytes", "MeteredSource"]


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


# ---------------------------------------------------------------------------
# Device residency sampling
# ---------------------------------------------------------------------------

def live_device_bytes() -> int:
    """Bytes of tensors live on the process's CUDA devices
    (``torch.cuda.memory_allocated``, summed over the cards).  0 on a host
    without a card: CPU tensors are host memory, not device residency."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return sum(torch.cuda.memory_allocated(d)
               for d in range(torch.cuda.device_count()))


class MeteredSource:
    """Wrap a chunk source; track the peak of ``live_device_bytes`` across
    chunk fetches (the streamed ID's residency meter).  With a ``gauge``,
    every sample is also recorded there, so a traced run exports the
    residency track next to the chunk spans.

    The optional ``sigmas`` / ``fingerprint`` / ``close`` surfaces
    delegate to the wrapped source: metering changes neither the resume
    identity nor the wrapped source's lifetime."""

    def __init__(self, inner, *, gauge: Optional[Gauge] = None):
        self._inner = inner
        self._gauge = gauge
        self.shape = inner.shape
        self.dtype = inner.dtype
        self.chunk_rows = inner.chunk_rows
        self.peak_bytes = 0

    @property
    def sigmas(self):
        return getattr(self._inner, "sigmas", None)

    def fingerprint(self):
        fp = getattr(self._inner, "fingerprint", None)
        return fp() if callable(fp) else fp

    def chunk(self, c: int):
        live = live_device_bytes()
        self.peak_bytes = max(self.peak_bytes, live)
        if self._gauge is not None:
            self._gauge.set(live)
        return self._inner.chunk(c)

    def close(self):
        close = getattr(self._inner, "close", None)
        if callable(close):
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
