"""The LM stack's models (counterpart of ``repro.models``): every
architecture of the reference, for serving and training: the
attention-only stacks, dense or MoE (granite-3-2b, qwen3-8b,
h2o-danube-1.8b, qwen2-7b, phi3.5-moe, qwen2-moe-a2.7b), jamba-v0.1-52b's
hybrid Mamba + attention stack, xlstm-125m's mLSTM and sLSTM layers,
whisper-tiny's encoder-decoder and qwen2-vl-2b's vision stub with M-RoPE."""
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
