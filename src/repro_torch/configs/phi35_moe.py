"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]

The reference's launcher shards the 16 experts over its 16-wide ``model``
axis (expert parallelism), and so does the port's (``launch.sharding``);
on one card it holds all 16 experts of a layer.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,                   # every FFN is MoE
    vocab_size=32064,
    moe=True,
    n_experts=16,
    n_experts_active=2,
    moe_d_ff=6400,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       vocab_size=256, n_experts=4, n_experts_active=2,
                       moe_d_ff=96, remat=False)
