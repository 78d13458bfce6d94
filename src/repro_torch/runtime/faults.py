"""Seeded fault injection + retry (counterpart of
``repro.runtime.faults``): the resilience layer's test harness and its
production backoff policy, in one module.

The streamed decomposition is a long-running job over thousands of
chunk reads (the paper's 64 GB headline is ~10k chunks at 512 rows);
at that scale transient read errors, stalls, dying sources, and plain
process kills are the NORMAL case, not the exception (Yang, Meng &
Mahoney, arXiv 1502.03032, make fault tolerance a first-class
requirement for distributed randomized matrix algorithms).  This module
supplies both halves of making that survivable:

  * :class:`FaultPlan` + :class:`FlakySource` — a deterministic,
    seeded fault-injection harness: the plan is the single source of truth for
    WHAT goes wrong (per-chunk transient read errors, stalls, permanent
    source death, process-kill points) and the wrapper realizes it
    against any :class:`~repro_torch.stream.chunks.ChunkSource` without the
    wrapped source knowing.  Every decision flows from the seed through
    the port's own counter rule (``_uniform``: ``core.rng.block_seed``
    folded over ``(chunk, attempt)``), so a failing chaos run reproduces
    exactly from its seed.
  * :class:`RetryPolicy` — exponential backoff with seeded jitter and
    per-read timeouts, driven ENTIRELY through the injectable
    ``repro_torch.obs.clock`` :class:`~repro_torch.obs.clock.Clock`
    (``clock()`` for elapsed time, ``clock.sleep`` for backoff).  With a
    ``FakeClock`` every retry test is instant and deterministic.  Retries emit ``stream.retry``
    counters/spans and exhausted chunks emit ``stream.chunk_failures``
    through the ambient obs layer.

Exception taxonomy (what retries, what kills):

  exception              meaning                          retried?
  TransientReadError     one read failed; retry may win   yes (default)
  ReadTimeout            read exceeded ``timeout_s``      yes (default)
  SourceDied             permanent: the source is gone    no — resume
                                                          from checkpoint
                                                          with a new one
  ChunkReadFailed        retry budget exhausted           no (terminal)
  ProcessKilled          simulated SIGKILL at a chunk     never caught:
                         boundary                         BaseException,
                                                          outside the
                                                          Exception tree
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Mapping, Optional

from ..core.rng import block_seed
from ..obs import trace as obs_trace
from ..obs.clock import MONOTONIC, Clock

__all__ = ["FaultPlan", "FlakySource", "RetryPolicy", "TransientReadError",
           "ReadTimeout", "SourceDied", "ChunkReadFailed", "ProcessKilled",
           "CHAOS_SEED_ENV", "CHAOS_P_ENV"]

CHAOS_SEED_ENV = "REPRO_CHAOS_SEED"
CHAOS_P_ENV = "REPRO_CHAOS_P"


class TransientReadError(RuntimeError):
    """One chunk read failed; an identical retry may succeed."""


class ReadTimeout(RuntimeError):
    """A chunk read took longer than the policy's ``timeout_s``."""


class SourceDied(RuntimeError):
    """The source is permanently gone — no retry can succeed; resume
    from checkpoint against a replacement source instead."""


class ChunkReadFailed(RuntimeError):
    """Terminal: a chunk stayed unreadable through the whole retry
    budget (carries ``chunk`` and ``attempts``)."""

    def __init__(self, description: str, attempts: int):
        super().__init__(f"{description} still failing after "
                         f"{attempts} attempts")
        self.attempts = attempts


class ProcessKilled(BaseException):
    """Simulated process kill (SIGKILL semantics): deliberately a
    BaseException so neither :class:`RetryPolicy` nor any engine-level
    ``except Exception`` quarantine can swallow it — exactly like the
    real signal, only the checkpoint survives."""


def _uniform(seed: int, *folds: int) -> float:
    """Deterministic u ~ U[0,1) from a seed and an integer fold path: the
    module's one randomness primitive, ``block_seed`` folded over each
    fold (a function of the path alone), its top 53 bits over 2^53."""
    h = int(seed)
    for f in folds:
        h = block_seed(h, int(f))
    return (h >> 11) * 2.0 ** -53


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded schedule of everything that will go wrong.

    Args:
      seed: drives every probabilistic decision (``_uniform(seed, chunk,
        attempt)``) — same seed, same faults, bit-for-bit.
      transient_p: probability that any given (chunk, attempt) read
        raises :class:`TransientReadError`.  Independent per attempt, so
        retries eventually win for p < 1.
      transient: explicit overrides — chunk index -> number of LEADING
        attempts that fail deterministically (for pinpoint tests).
      stall_s: chunk index -> extra seconds the FIRST read of that chunk
        takes (realized via the injected clock's ``sleep``, so a
        ``FakeClock`` makes stalls free); what a ``RetryPolicy`` timeout
        turns into a :class:`ReadTimeout`.
      die_at: chunk index at which the source dies PERMANENTLY — every
        read of that chunk or any later one raises :class:`SourceDied`.
      kill_at: chunk indices whose FIRST read raises
        :class:`ProcessKilled` (once each per :class:`FlakySource`
        instance) — the checkpoint/resume kill points.
    """

    seed: int = 0
    transient_p: float = 0.0
    transient: Mapping[int, int] = dataclasses.field(default_factory=dict)
    stall_s: Mapping[int, float] = dataclasses.field(default_factory=dict)
    die_at: Optional[int] = None
    kill_at: tuple = ()

    def __post_init__(self):
        if not 0.0 <= self.transient_p < 1.0:
            raise ValueError(f"need 0 <= transient_p < 1 (p == 1 can never "
                             f"be retried through), got "
                             f"transient_p={self.transient_p}")

    @classmethod
    def from_env(cls, *, transient_p: Optional[float] = None) -> "FaultPlan":
        """The CI chaos lane's constructor: seed from ``$REPRO_CHAOS_SEED``
        (default 0), transient probability from ``$REPRO_CHAOS_P``
        (default 0.2 — the acceptance plan)."""
        seed = int(os.environ.get(CHAOS_SEED_ENV, "0"))
        if transient_p is None:
            transient_p = float(os.environ.get(CHAOS_P_ENV, "0.2"))
        return cls(seed=seed, transient_p=transient_p)

    def transient_hits(self, chunk: int, attempt: int) -> bool:
        """Does read ``attempt`` (0-based) of ``chunk`` transiently fail?"""
        if attempt < int(self.transient.get(chunk, 0)):
            return True
        if self.transient_p <= 0.0:
            return False
        return _uniform(self.seed, chunk, attempt) < self.transient_p


class FlakySource:
    """A :class:`~repro_torch.stream.chunks.ChunkSource` that misbehaves on
    schedule.  Wraps any conforming source and realizes a
    :class:`FaultPlan` against it; geometry (``shape`` / ``dtype`` /
    ``chunk_rows``) and the optional ``sigmas`` / ``fingerprint`` /
    ``close`` surfaces delegate to the wrapped source, so the pipeline
    (and the resume fingerprint) cannot tell the difference on the
    healthy path — and wrapping a ``FileSource`` still releases its
    mmap and read-ahead thread on ``close()``.

    ``injected`` tallies what actually fired, keyed by fault kind —
    the chaos lane's report reads it straight off the source.
    """

    def __init__(self, inner, plan: FaultPlan, *, clock: Clock = MONOTONIC):
        self.inner = inner
        self.plan = plan
        self.clock = clock
        self.shape = inner.shape
        self.dtype = inner.dtype
        self.chunk_rows = inner.chunk_rows
        self.injected = {"transient": 0, "stall": 0, "dead": 0, "kill": 0}
        self._attempts: dict[int, int] = {}
        self._killed: set[int] = set()
        self._stalled: set[int] = set()

    @property
    def sigmas(self):
        return getattr(self.inner, "sigmas", None)

    def fingerprint(self):
        fp = getattr(self.inner, "fingerprint", None)
        return fp() if callable(fp) else fp

    def chunk(self, c: int):
        plan = self.plan
        if c in plan.kill_at and c not in self._killed:
            self._killed.add(c)
            self.injected["kill"] += 1
            raise ProcessKilled(f"injected process kill at chunk {c}")
        if plan.die_at is not None and c >= plan.die_at:
            self.injected["dead"] += 1
            raise SourceDied(f"source died at chunk {plan.die_at}; "
                             f"chunk {c} is unreadable forever")
        attempt = self._attempts.get(c, 0)
        self._attempts[c] = attempt + 1
        if c in plan.stall_s and c not in self._stalled:
            self._stalled.add(c)
            self.injected["stall"] += 1
            self.clock.sleep(float(plan.stall_s[c]))
        if plan.transient_hits(c, attempt):
            self.injected["transient"] += 1
            raise TransientReadError(f"injected transient read error: "
                                     f"chunk {c}, attempt {attempt}")
        return self.inner.chunk(c)

    def close(self):
        """Delegate to the wrapped source (``FileSource`` owns a mmap and
        a read-ahead thread); a no-op for sources without ``close``."""
        close = getattr(self.inner, "close", None)
        if callable(close):
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RetryPolicy:
    """Exponential backoff + seeded jitter + per-read timeouts, all
    through the injectable clock.

    ``call(fn, description=...)`` runs ``fn`` up to ``max_attempts``
    times.  A retryable exception (or a read that took longer than
    ``timeout_s`` — the elapsed-clock timeout contract: the value is
    DISCARDED and the read retried) costs one attempt and one backoff
    sleep of ``base_delay_s * 2**attempt``, capped at ``max_delay_s``
    and scaled by ``1 + U[0, jitter)`` from the policy's own seeded
    stream.  Exhausting the budget raises :class:`ChunkReadFailed` from
    the last error and bumps the ``stream.chunk_failures`` counter;
    every retry bumps ``stream.retry`` and records a ``stream.retry``
    span around the backoff sleep.
    """

    def __init__(self, *, max_attempts: int = 4, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, jitter: float = 0.25,
                 timeout_s: Optional[float] = None, seed: int = 0,
                 retryable: tuple = (TransientReadError, ReadTimeout),
                 clock: Clock = MONOTONIC):
        if max_attempts < 1:
            raise ValueError(f"need max_attempts >= 1, got "
                             f"max_attempts={max_attempts}")
        if base_delay_s < 0 or max_delay_s < 0:
            raise ValueError(f"need non-negative delays, got "
                             f"base_delay_s={base_delay_s}, "
                             f"max_delay_s={max_delay_s}")
        if jitter < 0:
            raise ValueError(f"need jitter >= 0, got jitter={jitter}")
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.timeout_s = timeout_s
        self.retryable = tuple(retryable)
        self.clock = clock
        self._seed = int(seed)
        self._draws = 0

    def backoff_s(self, attempt: int) -> float:
        """The post-attempt sleep: exp backoff x seeded jitter (each call
        consumes one draw from the policy's jitter stream)."""
        delay = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        if self.jitter > 0:
            self._draws += 1
            delay *= 1.0 + self.jitter * _uniform(self._seed, self._draws)
        return delay

    def call(self, fn: Callable, *, description: str = "read",
             on_retry: Optional[Callable] = None):
        """Run ``fn`` under the policy.  ``on_retry(attempt, error)`` is
        invoked once per retry (after the failed attempt, before the
        backoff sleep) — how a :class:`~repro_torch.obs.progress.
        ProgressReporter` counts retries without this module knowing
        about progress reporting."""
        retry_ctr = obs_trace.counter("stream.retry")
        fail_ctr = obs_trace.counter("stream.chunk_failures")
        for attempt in range(self.max_attempts):
            t0 = self.clock()
            try:
                out = fn()
            except self.retryable as e:
                err = e
            else:
                elapsed = self.clock() - t0
                if self.timeout_s is not None and elapsed > self.timeout_s:
                    err = ReadTimeout(f"{description} took {elapsed:.3f}s "
                                      f"> timeout_s={self.timeout_s}")
                else:
                    return out
            if attempt + 1 >= self.max_attempts:
                fail_ctr.add(1)
                raise ChunkReadFailed(description, self.max_attempts) from err
            retry_ctr.add(1)
            if on_retry is not None:
                on_retry(attempt + 1, err)
            delay = self.backoff_s(attempt)
            with obs_trace.span("stream.retry", attempt=attempt + 1,
                                delay_s=delay,
                                error=f"{type(err).__name__}: {err}"):
                self.clock.sleep(delay)
        raise AssertionError("unreachable")  # loop always returns or raises
