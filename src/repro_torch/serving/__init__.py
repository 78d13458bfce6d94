"""Serving (counterpart of ``repro.serving``): the batched request engine
and RID low-rank weight compression."""
from .compress import compress_params, compression_report, low_rank_targets
from .engine import GenerationRequest, ServeEngine

__all__ = ["ServeEngine", "GenerationRequest", "compress_params",
           "low_rank_targets", "compression_report"]
