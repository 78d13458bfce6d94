"""The device-residency sampler, re-exported (counterpart of
``repro.analysis.residency``): the one measurement path lives in
``repro_torch.obs.metrics`` (``live_device_bytes``, ``MeteredSource``),
where the streamed ID's gauge and ``bench_stream`` read it too."""
from __future__ import annotations

from ..obs.metrics import MeteredSource, live_device_bytes

__all__ = ["live_device_bytes", "MeteredSource"]
