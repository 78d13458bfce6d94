"""The assigned input-shape grid and its stand-ins (counterpart of
``repro.launch.shapes``).

  train_4k      seq=4,096   global_batch=256   -> train_step
  prefill_32k   seq=32,768  global_batch=32    -> prefill (serve)
  decode_32k    seq=32,768  global_batch=128   -> decode_step, KV len 32k
  long_500k     seq=524,288 global_batch=1     -> decode_step, KV len 500k
                 (sub-quadratic archs only -- SWA / SSM / hybrid)

``input_specs`` returns tensors on the ``meta`` device: shapes and dtypes,
never allocated (the dry-run's contract; the reference's
ShapeDtypeStructs).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import caches_shape

__all__ = ["ShapeCase", "SHAPES", "cell_applicable", "input_specs"]


class ShapeCase(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason).  long_500k needs sub-quadratic decode state."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention decode state at 500k context is "
                       "quadratic-cost / O(S) KV — skipped per assignment "
                       "(sub-quadratic archs only)")
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Meta-tensor stand-ins for every model input of the cell."""
    case = SHAPES[shape]
    B, S = case.global_batch, case.seq_len
    tok = torch.int32
    if case.kind in ("train", "prefill"):
        d = {"tokens": _sds((B, S), tok)}
        if case.kind == "train":
            d["labels"] = _sds((B, S), tok)
        if cfg.encdec:
            d["frames"] = _sds((B, cfg.n_frontend_tokens, cfg.d_model),
                               torch.bfloat16)
        return d
    # decode: one new token against a cache of S; per-sequence positions
    return {"tokens": _sds((B, 1), tok),
            "pos": _sds((B,), torch.int32),
            "caches": caches_shape(cfg, B, S)}
