"""Reduce a profiler trace of whole IDs to per-stage device time, launches,
the device's busy and idle time, and a breakdown.

Input: the raw Kineto events of a ``torch.profiler`` session
(``prof.profiler.kineto_results.events()``), kept in memory.  A device
operation (kernel, copy or set) belongs to the host range that launched
it: its correlation id leads to the runtime call (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) on the host, and the range whose host span holds
that call owns it.  Operations launched outside the traced IDs are left
out.

The traced window runs from the first ``bench.id`` span's start to the last
one's end.  Busy time is the union of the device operations' intervals in
it, so operations that overlap count once; idle is the rest.  Each idle
gap is named by what the host was doing at its middle: the innermost host
event open then on the thread that ran the IDs.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

__all__ = ["Summary", "summarize", "TOP"]

TOP = 10
_NAME_CHARS = 120


@dataclass
class Summary:
    ids: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    ranges: dict = field(default_factory=dict)   # name -> {"device_s", "launches"}
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _is_launch_of_work(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def _inside(spans, t) -> bool:
    """``t`` inside one of the sorted, disjoint ``spans``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def summarize(events, id_range: str, ranges: tuple) -> Summary:
    """The summary of the IDs traced under ``id_range``, with the device
    time and launches of each range in ``ranges``."""
    host, device, runtime = {}, [], {}
    for e in events:
        name = e.name()
        if _is_device(e):
            if not e.is_user_annotation():
                device.append(e)
        elif e.is_user_annotation():
            host.setdefault(name, []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.start_thread_id()))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
    out = Summary(ranges={r: {"device_s": 0.0, "launches": 0}
                          for r in ranges})
    ids = sorted(host.get(id_range, []))
    if not ids:
        return out
    out.ids = len(ids)
    w0, w1 = ids[0][0], max(hi for _, hi, _ in ids)
    out.window_s = (w1 - w0) / 1e9
    id_spans = [(lo, hi) for lo, hi, _ in ids]
    spans = {r: sorted((lo, hi) for lo, hi, _ in host.get(r, []))
             for r in ranges}
    busy, by_name = [], {}
    for e in device:
        lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        t = runtime.get(e.correlation_id())
        if t is None or not _inside(id_spans, t):
            continue
        owner = next((r for r in ranges if _inside(spans[r], t)), None)
        name = e.name()
        if owner is not None:
            out.ranges[owner]["device_s"] += (hi - lo) / 1e9
            out.ranges[owner]["launches"] += _is_launch_of_work(name)
        busy.append((max(lo, w0), min(hi, w1)))
        key = name[:_NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (hi - lo) / 1e9
    merged = _union([iv for iv in busy if iv[1] > iv[0]])
    out.busy_s = sum(hi - lo for lo, hi in merged) / 1e9
    out.device_ops = [[k, v] for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    gaps, t = [], w0
    for lo, hi in merged:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    if w1 > t:
        gaps.append((t, w1))
    out.idle_gaps = _name_gaps(gaps, events, ids[0][2])
    return out


def _name_gaps(gaps, events, thread) -> list:
    """Seconds of idle device time by the innermost host event open at each
    gap's middle on ``thread`` (``host idle`` where none is)."""
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events
                  if not _is_device(e) and e.start_thread_id() == thread)
    mids = sorted(((lo + hi) / 2, hi - lo) for lo, hi in gaps)
    totals, stack, i = {}, [], 0
    for mid, dur in mids:
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        stack = [ev for ev in stack if ev[1] >= mid]
        name = stack[-1][2][:_NAME_CHARS] if stack else "host idle"
        totals[name] = totals.get(name, 0.0) + dur / 1e9
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
