"""Straggler detection and mitigation (counterpart of
``repro.runtime.straggler``).

Per-host step-time EWMAs; a host whose EWMA exceeds ``threshold`` times
the fleet median is flagged.  The mitigation is the paper's own knob: the
gradient-compression rank drops one tier (less traffic through the slow
host's links).  Tiers are fixed ranks, so each tier is a step function
built once; the training loop swaps functions and builds nothing mid-tier.

Two details keep it stable:

* the fleet median is the TRUE median (the mean of the two middle EWMAs
  for an even host count): the upper-middle shortcut biases the reference
  high on small fleets and hides a real straggler behind it;
* recovery is hysteretic: the rank climbs back only after
  ``recovery_steps`` consecutive clear ``adapt()`` checks.  Dropping a
  tier is cheap; flapping between step functions every other step is not.

Timing goes through the observability layer: ``step(host)`` returns a
context manager that brackets one training step with the injected clock
(``repro_torch.obs.clock``), records the elapsed seconds into the host's
EWMA, and observes it into the ambient ``runtime.step_seconds`` histogram
when a tracer is active.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

from ..obs import trace as obs_trace
from ..obs.clock import MONOTONIC, Clock


class StragglerMonitor:
    def __init__(self, n_hosts: int, *, alpha: float = 0.2,
                 threshold: float = 1.5,
                 rank_tiers: Sequence[int] = (32, 16, 8, 4),
                 recovery_steps: int = 3,
                 clock: Clock = MONOTONIC):
        if recovery_steps < 1:
            raise ValueError(f"need recovery_steps >= 1, got "
                             f"{recovery_steps}")
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.rank_tiers = tuple(rank_tiers)
        self.recovery_steps = recovery_steps
        self._clock = clock
        self._tier = 0
        self._clear_streak = 0
        self._ewma: dict[int, float] = {}

    def record(self, host: int, step_seconds: float):
        prev = self._ewma.get(host)
        self._ewma[host] = (step_seconds if prev is None
                            else (1 - self.alpha) * prev + self.alpha * step_seconds)

    @contextlib.contextmanager
    def step(self, host: int):
        """Time one training step with the obs clock and feed the host's
        EWMA (plus the ambient ``runtime.step_seconds`` histogram when a
        tracer is active).  The timed region is host wall time: bracket
        the synchronized step, not an asynchronous dispatch."""
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            self.record(host, dt)
            obs_trace.histogram("runtime.step_seconds").observe(dt)

    @property
    def fleet_median(self) -> Optional[float]:
        if not self._ewma:
            return None
        vals = sorted(self._ewma.values())
        mid = len(vals) // 2
        if len(vals) % 2:
            return vals[mid]
        return 0.5 * (vals[mid - 1] + vals[mid])

    def stragglers(self) -> list[int]:
        med = self.fleet_median
        if med is None or med <= 0:
            return []
        return [h for h, v in self._ewma.items() if v > self.threshold * med]

    @property
    def compression_rank(self) -> int:
        return self.rank_tiers[self._tier]

    def adapt(self) -> bool:
        """Drop one rank tier if stragglers persist; climb back one tier
        only after ``recovery_steps`` consecutive clear checks
        (hysteresis).  Returns True when the tier changed (the caller
        swaps to that tier's step function)."""
        if self.stragglers():
            self._clear_streak = 0
            if self._tier + 1 < len(self.rank_tiers):
                self._tier += 1
                return True
            return False
        self._clear_streak += 1
        if self._tier > 0 and self._clear_streak >= self.recovery_steps:
            self._tier -= 1
            self._clear_streak = 0
            return True
        return False
