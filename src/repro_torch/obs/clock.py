"""The port's one wall-clock source (counterpart of ``repro.obs.clock``).

Library code of the serving path takes an injectable :class:`Clock`
(defaulting to :data:`MONOTONIC`) instead of reading ``time.*`` itself, so
tests swap in a :class:`FakeClock` and every timing-dependent behaviour
(spans, deadlines) becomes deterministic.

A clock is just a zero-argument callable returning seconds as a float;
the classes below exist for discoverability and for the fake's control
surface, but any ``Callable[[], float]`` satisfies the contract.  Code
that waits calls ``clock.sleep(dt)`` on its injected clock:
``FakeClock.sleep`` advances the fake time instead of blocking.
"""
from __future__ import annotations

import time
from typing import Callable

__all__ = ["Clock", "MonotonicClock", "FakeClock", "MONOTONIC", "now"]

# The contract: a zero-arg callable returning monotonic seconds.
Clock = Callable[[], float]


class MonotonicClock:
    """The production clock: monotonic, high-resolution, origin-free."""

    def __call__(self) -> float:
        return time.perf_counter()

    def sleep(self, dt: float) -> None:
        """Block for ``dt`` seconds (the one sanctioned ``time.sleep``)."""
        if dt < 0:
            raise ValueError(f"need dt >= 0, got dt={dt}")
        time.sleep(dt)


class FakeClock:
    """Deterministic test clock: starts at ``start``, moves only when
    told.  ``tick`` (default 0) auto-advances the clock by that much on
    every read, so code that computes a duration between two reads sees
    a stable, predictable value without any explicit ``advance`` calls.
    ``sleep`` advances the fake time instead of blocking, and records
    each requested delay in ``sleeps`` so backoff tests can assert the
    exact schedule.
    """

    def __init__(self, start: float = 0.0, *, tick: float = 0.0):
        self.t = float(start)
        self.tick = float(tick)
        self.sleeps: list = []

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"need dt >= 0 (monotonic clock), got dt={dt}")
        self.t += dt

    def sleep(self, dt: float) -> None:
        """Advance time by ``dt`` without blocking (and log the call)."""
        if dt < 0:
            raise ValueError(f"need dt >= 0, got dt={dt}")
        self.sleeps.append(float(dt))
        self.t += dt

    def __call__(self) -> float:
        t = self.t
        self.t += self.tick
        return t


# The default instance injected everywhere a caller does not supply one.
MONOTONIC: Clock = MonotonicClock()


def now() -> float:
    """Read the default clock (monotonic seconds, origin-free)."""
    return MONOTONIC()
