"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408(dense
shared path), MoE 60 routed experts top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The reference's launcher shards the expert hidden dim (TP-MoE), since 60
experts do not divide its 16-wide ``model`` axis; so does the port's
(``launch.sharding``); on one card it holds all 60 experts of a layer.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,                   # every FFN is MoE (shared experts carry d_ff=1408)
    vocab_size=151936,
    moe=True,
    n_experts=60,
    n_experts_active=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       vocab_size=256, n_experts=8, n_experts_active=4,
                       n_shared_experts=2, moe_d_ff=48, remat=False)
