"""Live job progress (counterpart of ``repro.obs.progress``): done/total,
EWMA cadence → ETA, atomic status file.

A :class:`ProgressReporter` is the in-flight complement to the trace: the
trace explains a run after it finishes, the reporter answers "how far
along is it and when will it finish" WHILE a multi-hour streamed
decomposition is running.  ``rid_streamed`` accepts one via its
``progress=`` kwarg and calls :meth:`update` once per chunk; the
reporter maintains:

- done/total and per-phase position,
- an EWMA of per-unit cadence → remaining-time estimate (``eta_s``),
- retry / failure counts (wired from ``RetryPolicy.call(on_retry=...)``),
- checkpoint recency (``checkpoint_age_s`` — staleness at a glance),

and publishes a machine-readable status JSON with the SAME atomic
discipline as ``checkpoint/store.py`` (tmp file + fsync + ``os.replace``
+ parent-dir fsync): a reader polling the file can never observe a torn
write, only the previous or the next complete snapshot.

Clock discipline: the reporter never reads ``time.*`` — it takes an
injectable :class:`~repro_torch.obs.clock.Clock` (tests inject ``FakeClock``
and every ETA becomes exact arithmetic).  Publishing is rate-limited
(``min_publish_s``) so per-chunk updates on a fast job don't turn into
an fsync storm; ``force=True`` (used for phase transitions and
:meth:`finish`) bypasses the limiter.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

from .clock import Clock, MONOTONIC

__all__ = ["ProgressReporter"]


def _atomic_write_json(path: str, payload: dict) -> None:
    """tmp + fsync + rename + parent fsync — the checkpoint/store.py
    durability discipline, applied to one small JSON file."""
    directory = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(directory, f".tmp-{os.path.basename(path)}")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class ProgressReporter:
    """Job progress with EWMA cadence → ETA and atomic status JSON.

    ``path`` is the status file (optional — callbacks-only reporters
    are fine); ``callbacks`` are ``fn(status_dict)`` hooks invoked on
    every publish;
    ``alpha`` is the EWMA smoothing factor for per-unit cadence.
    """

    def __init__(self, path=None, *, clock: Clock = MONOTONIC,
                 callbacks=(), alpha: float = 0.3,
                 min_publish_s: float = 0.0, job: str = ""):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.path = None if path is None else str(path)
        self.clock = clock
        self.callbacks: list[Callable[[dict], None]] = list(callbacks)
        self.alpha = alpha
        self.min_publish_s = min_publish_s
        self.job = job
        self._t_start = clock()
        self._t_last_publish: Optional[float] = None
        self._t_last_unit: Optional[float] = None
        self._ewma_unit_s: Optional[float] = None
        self.done = 0
        self.total: Optional[int] = None
        self.phase = "start"
        self.retries = 0
        self.failures = 0
        self.checkpoints = 0
        self._t_last_checkpoint: Optional[float] = None
        self._last_checkpoint_step: Optional[int] = None
        self.state = "running"
        self.extra: dict = {}

    # ------------------------------------------------------------- inputs
    def update(self, *, done: Optional[int] = None,
               total: Optional[int] = None, phase: Optional[str] = None,
               extra: Optional[dict] = None, force: bool = False) -> None:
        """Record progress.  An *increase* in ``done`` feeds the cadence
        EWMA (elapsed-since-last-increase / units gained); a phase
        change publishes immediately."""
        now = self.clock()
        if total is not None:
            self.total = total
        if phase is not None and phase != self.phase:
            self.phase = phase
            force = True
        if extra:
            self.extra.update(extra)
        if done is not None and done > self.done:
            gained = done - self.done
            if self._t_last_unit is not None:
                dt = (now - self._t_last_unit) / gained
                if self._ewma_unit_s is None:
                    self._ewma_unit_s = dt
                else:
                    self._ewma_unit_s = (self.alpha * dt
                                         + (1 - self.alpha)
                                         * self._ewma_unit_s)
            self._t_last_unit = now
            self.done = done
        elif done is not None:
            self.done = done
            self._t_last_unit = now
        elif self._t_last_unit is None:
            self._t_last_unit = now
        self.publish(force=force)

    def on_retry(self, attempt: int, error: BaseException) -> None:
        """Hook shape matching ``RetryPolicy.call(on_retry=...)``."""
        self.retries += 1
        self.publish(force=True)

    def on_failure(self) -> None:
        self.failures += 1
        self.publish(force=True)

    def checkpoint_saved(self, step: int) -> None:
        self.checkpoints += 1
        self._t_last_checkpoint = self.clock()
        self._last_checkpoint_step = step
        self.publish(force=True)

    def finish(self, state: str = "done") -> None:
        """Terminal publish (``done`` / ``failed``); always writes."""
        self.state = state
        self.publish(force=True)

    # ------------------------------------------------------------ outputs
    def eta_s(self) -> Optional[float]:
        """Remaining seconds at the current EWMA cadence; None until a
        cadence exists or when total is unknown."""
        if (self.total is None or self._ewma_unit_s is None
                or self.done >= self.total):
            return 0.0 if (self.total is not None
                           and self.done >= self.total) else None
        return self._ewma_unit_s * (self.total - self.done)

    def status(self) -> dict:
        """The published snapshot (also what callbacks receive)."""
        now = self.clock()
        frac = (self.done / self.total
                if self.total not in (None, 0) else None)
        return {"job": self.job, "state": self.state, "phase": self.phase,
                "done": self.done, "total": self.total, "fraction": frac,
                "elapsed_s": now - self._t_start, "eta_s": self.eta_s(),
                "unit_ewma_s": self._ewma_unit_s,
                "retries": self.retries, "failures": self.failures,
                "checkpoints": self.checkpoints,
                "checkpoint_step": self._last_checkpoint_step,
                "checkpoint_age_s": (None if self._t_last_checkpoint is None
                                     else now - self._t_last_checkpoint),
                "extra": dict(self.extra)}

    def publish(self, *, force: bool = False) -> Optional[dict]:
        """Write the status file (atomically) and run callbacks, unless
        rate-limited.  Returns the snapshot when it published."""
        now = self.clock()
        if (not force and self._t_last_publish is not None
                and now - self._t_last_publish < self.min_publish_s):
            return None
        self._t_last_publish = now
        snap = self.status()
        if self.path is not None:
            _atomic_write_json(self.path, snap)
        for cb in self.callbacks:
            cb(snap)
        return snap
