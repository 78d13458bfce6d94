"""Heartbeat coordinator and elastic re-mesh planning (counterpart of
``repro.runtime.coordinator``).

Each host process ticks its heartbeat between steps; the coordinator
(rank 0, or an external service) marks hosts dead after ``timeout_s`` and
raises :class:`HostFailure`.  Recovery is planning logic, testable off a
cluster:

  1. the surviving chip count goes to :func:`plan_elastic_mesh`, which
     picks the largest production-shaped layout that still fits, keeping
     the ``model`` axis whole so tensor-parallel shardings stay valid
     (only data parallelism shrinks);
  2. the training loop rebuilds its process groups on that layout and
     restores the last checkpoint (``checkpoint.restore_pytree``, which
     knows no layout);
  3. the deterministic data pipeline replays from the restored step.

The clock is injected: the default is the port's wall-clock source
(``repro_torch.obs.clock``), and tests pass an ``obs.FakeClock``.
"""
from __future__ import annotations

from typing import Callable

from ..obs.clock import MONOTONIC


class HostFailure(RuntimeError):
    def __init__(self, dead_hosts: list[int], alive: int):
        super().__init__(f"hosts {dead_hosts} missed heartbeat; {alive} alive")
        self.dead_hosts = dead_hosts
        self.alive = alive


class Coordinator:
    """Heartbeat registry.  ``check()`` raises HostFailure when any host
    is silent for longer than ``timeout_s``."""

    def __init__(self, n_hosts: int, *, timeout_s: float = 60.0,
                 clock: Callable[[], float] = MONOTONIC):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self._last = {h: now for h in range(n_hosts)}
        self._dead: set[int] = set()

    def heartbeat(self, host: int):
        if host in self._dead:
            raise RuntimeError(f"host {host} was declared dead; must rejoin")
        self._last[host] = self.clock()

    def mark_dead(self, host: int):
        """Explicit failure injection (tests / external watchdog)."""
        self._dead.add(host)

    def rejoin(self, host: int):
        """Scale-up path: a replacement host joins before the next re-mesh."""
        self._dead.discard(host)
        self._last[host] = self.clock()

    @property
    def alive_hosts(self) -> list[int]:
        return [h for h in range(self.n_hosts) if h not in self._dead]

    def check(self):
        now = self.clock()
        newly = [h for h, t in self._last.items()
                 if h not in self._dead and now - t > self.timeout_s]
        if newly:
            self._dead.update(newly)
        if self._dead:
            raise HostFailure(sorted(self._dead), len(self.alive_hosts))


def plan_elastic_mesh(alive_chips: int, *, model_axis: int = 16,
                      chips_per_pod: int = 256) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest production-shaped mesh that fits on ``alive_chips``.

    Keeps ``model`` fixed (tensor-parallel shardings divide by the axis
    size, so it must stay valid) and shrinks data/pod parallelism to the
    largest power of two that fits.  Returns ``(shape, axis_names)`` of
    the layout, from which the caller builds its process groups.
    """
    if alive_chips < model_axis:
        raise ValueError(f"cannot keep model={model_axis} TP on "
                         f"{alive_chips} chips")
    pods = alive_chips // chips_per_pod
    if pods >= 2:
        return (pods, chips_per_pod // model_axis, model_axis), ("pod", "data", "model")
    data = 1
    while data * 2 * model_axis <= alive_chips:
        data *= 2
    return (data, model_axis), ("data", "model")
