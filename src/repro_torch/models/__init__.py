"""The LM stack's models (counterpart of ``repro.models``): so far the
attention-only path, dense or MoE, that granite-3-2b, qwen3-8b,
h2o-danube-1.8b, qwen2-7b, phi3.5-moe and qwen2-moe-a2.7b run, for serving
and training."""
from .config import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig
from .transformer import (Transformer, decode_step, forward, init_caches,
                          init_params, loss_fn, params_from_jax,
                          params_to_numpy, prefill, prefill_chunk,
                          supports_chunked_prefill)

__all__ = [
    "ModelConfig", "ATTN", "MAMBA", "MLSTM", "SLSTM", "Transformer",
    "init_params", "forward", "loss_fn", "prefill", "prefill_chunk",
    "supports_chunked_prefill", "decode_step", "init_caches",
    "params_from_jax", "params_to_numpy",
]
