"""Trace analytics (counterpart of ``repro.obs.timeline``): per-phase
time, critical path, overlap audit, throughput and stragglers.

A :class:`Timeline` is a read-only view over one finished trace, built
either from a live :class:`~repro_torch.obs.trace.Tracer` or from a JSONL
file the ``jsonl`` exporter wrote (both carry the same schema, so post-hoc
and in-process analysis share one code path).  It computes:

- **per-phase time** (:meth:`Timeline.phases`): wall and SELF time per
  span name, self time being a span's duration minus its direct
  children's, so nested spans are not counted twice and the phase table
  sums to the roots' duration.  :meth:`Timeline.critical_path` ranks the
  phases by self time.
- **overlap**: the host loop is single-threaded, so its spans never
  overlap each other and one trace cannot show how much of the host ->
  device copying was hidden.  Under ``overlap=False`` the
  ``stream.accumulate`` span waits for the device; under ``overlap=True``
  it times the dispatch.  :func:`overlap_report` therefore reads a PAIR of
  traces of the same job and reports the hidden fraction;
  :meth:`Timeline.psum_overlap` reads the ``qr.panel_schedule`` events
  the panel-parallel engine (``core.qr_dist``) records a panel.
- **throughput** (rows/s, bytes/s, chunks/s) from the stream spans and the
  metric snapshot of the same trace.
- **stragglers** (:meth:`Timeline.stragglers`): for each repeated phase,
  its slowest instance against the phase mean, named by its ``chunk=`` /
  ``panel=`` attributes.

Pure post-processing of a finished trace: no clock (the trace carries its
timestamps), no device work, nothing that changes the run analyzed.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

__all__ = ["TSpan", "PhaseStat", "Timeline", "overlap_report"]


@dataclass
class TSpan:
    """One finished span as the analyzer sees it: times rebased to the
    trace origin, events inlined as (name, ts, attrs) tuples."""
    name: str
    ts: float
    dur: float
    depth: int
    index: int
    attrs: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    self_dur: float = 0.0        # filled by Timeline: dur minus children


@dataclass
class PhaseStat:
    """Aggregate over all spans sharing one name."""
    name: str
    count: int = 0
    total: float = 0.0           # summed wall duration
    self_total: float = 0.0      # summed self time (no double counting)
    max_dur: float = 0.0
    max_index: int = -1          # index of the slowest instance

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Timeline:
    """Read-only analytics over one finished trace.

    ``spans`` are ordered by start index; ``metrics`` maps metric name to
    its snapshot dict (the same schema the ``jsonl`` exporter writes, so
    :meth:`from_tracer` and :meth:`from_jsonl` agree).
    """

    def __init__(self, spans: list[TSpan], metrics: Optional[dict] = None):
        self.spans = sorted(spans, key=lambda s: s.index)
        self.metrics = dict(metrics or {})
        self._fill_self_times()

    # ------------------------------------------------------------ builders
    @classmethod
    def from_tracer(cls, tracer) -> "Timeline":
        """Build from a live :class:`~repro_torch.obs.trace.Tracer` (finished
        or mid-flight; open spans are skipped)."""
        origin = tracer.t_origin or 0.0
        spans = [TSpan(name=sp.name, ts=sp.t0 - origin, dur=sp.dur,
                       depth=sp.depth, index=sp.index, attrs=dict(sp.attrs),
                       events=[(n, None if ts is None else ts - origin,
                                dict(a)) for n, ts, a in sp.events])
                 for sp in tracer.spans if sp.dur is not None]
        metrics = {m["name"]: m for m in tracer.metrics.snapshot()}
        return cls(spans, metrics)

    @classmethod
    def from_jsonl(cls, path) -> "Timeline":
        """Build from a JSONL trace file (``jsonl`` exporter schema:
        span lines, each followed by its event lines, then metrics)."""
        spans: list[TSpan] = []
        metrics: dict = {}
        last: Optional[TSpan] = None
        for raw in Path(path).read_text().splitlines():
            raw = raw.strip()
            if not raw:
                continue
            line = json.loads(raw)
            kind = line.get("type")
            if kind == "span":
                if line.get("dur") is None:
                    last = None
                    continue
                last = TSpan(name=line["name"], ts=line["ts"],
                             dur=line["dur"], depth=line["depth"],
                             index=line["index"],
                             attrs=line.get("attrs") or {})
                spans.append(last)
            elif kind == "event":
                # Event lines ride directly after their span's line.
                if last is not None:
                    last.events.append((line["name"], line.get("ts"),
                                        line.get("attrs") or {}))
            elif kind in ("counter", "gauge", "histogram"):
                metrics[line["name"]] = line
        return cls(spans, metrics)

    # ------------------------------------------------------- tree analysis
    def _fill_self_times(self) -> None:
        """Self time = duration minus direct children's durations.  The
        tracer records (index, depth) with stack discipline, so parents
        are recovered by a single stack sweep in index order."""
        stack: list[TSpan] = []
        child_time = {id(sp): 0.0 for sp in self.spans}
        for sp in self.spans:
            while stack and stack[-1].depth >= sp.depth:
                stack.pop()
            if stack:
                child_time[id(stack[-1])] += sp.dur
            stack.append(sp)
        for sp in self.spans:
            sp.self_dur = max(0.0, sp.dur - child_time[id(sp)])

    def phases(self) -> dict[str, PhaseStat]:
        """Aggregate spans by name: count, wall total, self total, and
        the slowest instance."""
        out: dict[str, PhaseStat] = {}
        for sp in self.spans:
            st = out.setdefault(sp.name, PhaseStat(name=sp.name))
            st.count += 1
            st.total += sp.dur
            st.self_total += sp.self_dur
            if sp.dur >= st.max_dur:
                st.max_dur, st.max_index = sp.dur, sp.index
        return out

    def critical_path(self) -> list[tuple[str, float]]:
        """Phases ranked by summed SELF time, descending — the answer to
        "where did the wall-clock go", with no double counting (the
        fractions sum to the roots' total duration)."""
        ranked = sorted(((st.name, st.self_total)
                         for st in self.phases().values()),
                        key=lambda kv: -kv[1])
        return ranked

    def wall(self) -> float:
        """End-to-end wall time: summed duration of depth-0 spans."""
        return sum(sp.dur for sp in self.spans if sp.depth == 0)

    # ----------------------------------------------------------- overlap
    def psum_overlap(self) -> Optional[float]:
        """Fraction of distributed-QR panels whose psum overlapped the
        next panel's compute, read off the ``qr.panel_schedule`` events
        (``psum="overlapped" | "serialized"``).  None when the trace has
        no such events (single-device run)."""
        total = overlapped = 0
        for sp in self.spans:
            for name, _ts, attrs in sp.events:
                if name == "qr.panel_schedule" and "psum" in attrs:
                    total += 1
                    overlapped += attrs["psum"] == "overlapped"
        return None if total == 0 else overlapped / total

    # -------------------------------------------------------- throughput
    def throughput(self) -> dict:
        """Streamed-RID throughput: chunks/rows from the pass-1 span
        attrs, bytes from the ``stream.h2d_bytes`` counter, all over the
        root ``rid_streamed`` duration (falls back to total wall)."""
        root = next((sp for sp in self.spans if sp.name == "rid_streamed"),
                    None)
        seconds = root.dur if root is not None else self.wall()
        chunks = sum(1 for sp in self.spans if sp.name == "stream.h2d")
        rows = sum(sp.attrs.get("rows", 0) for sp in self.spans
                   if sp.name == "stream.accumulate")
        nbytes = (self.metrics.get("stream.h2d_bytes") or {}).get("value", 0)
        safe = seconds if seconds > 0 else float("inf")
        return {"seconds": seconds, "chunks": chunks, "rows": rows,
                "bytes": nbytes, "chunks_per_s": chunks / safe,
                "rows_per_s": rows / safe, "bytes_per_s": nbytes / safe}

    # -------------------------------------------------------- stragglers
    def stragglers(self, min_count: int = 2) -> list[dict]:
        """Per repeated phase, the slowest instance vs the phase mean,
        attributed by ``chunk=`` / ``panel=`` attrs.  Sorted by ratio,
        worst first."""
        by_index = {sp.index: sp for sp in self.spans}
        out = []
        for st in self.phases().values():
            if st.count < min_count or st.mean <= 0:
                continue
            worst = by_index[st.max_index]
            where = {k: worst.attrs[k] for k in ("chunk", "panel", "job")
                     if k in worst.attrs}
            out.append({"phase": st.name, "count": st.count,
                        "mean_s": st.mean, "max_s": st.max_dur,
                        "ratio": st.max_dur / st.mean, **where})
        return sorted(out, key=lambda r: -r["ratio"])

    # ------------------------------------------------------------ report
    def report(self) -> dict:
        """One JSON-able dict with everything above."""
        phases = {name: {"count": st.count, "total_s": st.total,
                         "self_s": st.self_total, "mean_s": st.mean,
                         "max_s": st.max_dur}
                  for name, st in sorted(self.phases().items())}
        return {"wall_s": self.wall(), "phases": phases,
                "critical_path": self.critical_path(),
                "psum_overlap": self.psum_overlap(),
                "throughput": self.throughput(),
                "stragglers": self.stragglers(),
                "metrics": self.metrics}


def _phase_sum(tl: Timeline, name: str) -> float:
    st = tl.phases().get(name)
    return st.total if st is not None else 0.0


def overlap_report(pipelined: Timeline, serialized: Timeline) -> dict:
    """Measured H2D-hidden fraction from an ``overlap=True`` /
    ``overlap=False`` trace pair of the same job.

    In the serialized trace both ``stream.h2d`` and ``stream.accumulate``
    block on the device, so their summed durations are true exposed
    time.  In the pipelined trace the accumulate spans are dispatch-only
    — device GEMMs hide under the next chunk's H2D — so the *drop* in
    summed exposed time between the two traces is exactly the work the
    pipeline hid.  Normalizing by the smaller of the two serialized
    phase totals (an upper bound on what double-buffering CAN hide)
    gives a fraction in [0, 1]:

        hidden = clamp((exposed_serial − exposed_pipe)
                       / min(Σ h2d_serial, Σ acc_serial), 0, 1)

    The serialized run's own hidden fraction is 0 by construction.
    """
    h2d_s = _phase_sum(serialized, "stream.h2d")
    acc_s = _phase_sum(serialized, "stream.accumulate")
    h2d_p = _phase_sum(pipelined, "stream.h2d")
    acc_p = _phase_sum(pipelined, "stream.accumulate")
    exposed_s = h2d_s + acc_s
    exposed_p = h2d_p + acc_p
    denom = min(h2d_s, acc_s)
    if denom > 0:
        hidden = max(0.0, min(1.0, (exposed_s - exposed_p) / denom))
    else:
        hidden = 0.0
    wall_p, wall_s = pipelined.wall(), serialized.wall()
    return {"h2d_serial_s": h2d_s, "accumulate_serial_s": acc_s,
            "h2d_pipelined_s": h2d_p, "accumulate_pipelined_s": acc_p,
            "exposed_serial_s": exposed_s, "exposed_pipelined_s": exposed_p,
            "hidden_fraction": hidden,
            "wall_pipelined_s": wall_p, "wall_serialized_s": wall_s,
            "speedup": wall_s / wall_p if wall_p > 0 else float("inf")}
