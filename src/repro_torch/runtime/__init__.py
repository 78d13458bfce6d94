"""Runtime resilience of the port (counterpart of ``repro.runtime``): the
seeded fault-injection harness and the retry policy of the streamed ID."""
from .faults import (CHAOS_P_ENV, CHAOS_SEED_ENV, ChunkReadFailed, FaultPlan,
                     FlakySource, ProcessKilled, ReadTimeout, RetryPolicy,
                     SourceDied, TransientReadError)

__all__ = ["FaultPlan", "FlakySource", "RetryPolicy", "TransientReadError",
           "ReadTimeout", "SourceDied", "ChunkReadFailed", "ProcessKilled",
           "CHAOS_SEED_ENV", "CHAOS_P_ENV"]
