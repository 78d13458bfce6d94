"""Runtime resilience of the port (counterpart of ``repro.runtime``): the
seeded fault-injection harness and the retry policy of the streamed ID,
the heartbeat coordinator with elastic re-mesh planning, and straggler
detection with an adaptive compression rank."""
from .coordinator import Coordinator, HostFailure, plan_elastic_mesh
from .faults import (CHAOS_P_ENV, CHAOS_SEED_ENV, ChunkReadFailed, FaultPlan,
                     FlakySource, ProcessKilled, ReadTimeout, RetryPolicy,
                     SourceDied, TransientReadError)
from .straggler import StragglerMonitor

__all__ = ["Coordinator", "HostFailure", "plan_elastic_mesh",
           "StragglerMonitor", "FaultPlan", "FlakySource", "RetryPolicy",
           "TransientReadError", "ReadTimeout", "SourceDied",
           "ChunkReadFailed", "ProcessKilled", "CHAOS_SEED_ENV",
           "CHAOS_P_ENV"]
