"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
enc-dec, conv frontend (stub).  [arXiv:2212.04356; unverified]

4 encoder + 4 decoder layers; the mel-conv tower is a stub and
the model takes precomputed frame embeddings (B, 1500, 384).
The decoder's positional encoding is RoPE in this backbone (the
assignment pins the transformer shape, not the PE); the encoder has none
beyond the frontend's learned table.  Every norm is a LayerNorm, the MLPs
are GELU.  The serving engine passes no frames, so it refuses this config
(``serving.ServeEngine``); ``models.prefill(..., frames=)`` and
``decode_step`` serve it directly.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,               # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    encdec=True,
    n_encoder_layers=4,
    n_frontend_tokens=1500,   # 30 s of audio at 50 frames/s
    norm_eps=1e-5,
)

SMOKE = CONFIG.replace(n_layers=2, n_encoder_layers=2, d_model=48, n_heads=4,
                       n_kv_heads=4, d_ff=96, vocab_size=256,
                       n_frontend_tokens=24, remat=False)
