"""Optimizer stack of the port (counterpart of ``repro.optim``): AdamW,
clipping, schedules and RandLR gradient compression."""
from .adamw import (AdamWState, adamw_init, adamw_update, clip_by_global_norm,
                    global_norm)
from .compress import CompressorConfig, compress_grads, ef_init
from .schedule import constant, warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm",
    "CompressorConfig", "compress_grads", "ef_init",
    "warmup_cosine", "constant",
]
