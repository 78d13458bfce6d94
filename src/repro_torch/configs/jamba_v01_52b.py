"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every
other layer.  [arXiv:2403.19887; hf]

Pattern period 8 (one attention layer per 8, offset 4 as released);
MoE every 2nd layer.  The reference's launcher shards the 16 experts over
its ``model`` axis (EP); the port runs on one card, where one period of 8
layers at full width (1.326e10 parameters, 53.1 GB in f32) is the
largest jamba that fits: 32 layers are 206 GB in f32 (sharding is
ROADMAP Queue A item 3.7).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,               # dense (non-MoE) layers' MLP width
    vocab_size=65536,
    moe=True,
    n_experts=16,
    n_experts_active=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    attn_layer_period=8,      # 1:7 attention:mamba
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256, n_experts=4,
                       n_experts_active=2, moe_d_ff=128, remat=False)
