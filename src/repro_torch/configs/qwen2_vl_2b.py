"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Backbone only; the vision tower is a stub (the model takes precomputed
patch embeddings, ``forward(..., patches=)``) per the assignment.  Text
ids run M-RoPE with t == h == w, which equals plain RoPE.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),   # t/h/w splits of head_dim//2 = 64
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
                       d_ff=192, vocab_size=256, mrope_sections=(4, 4, 4),
                       remat=False)
