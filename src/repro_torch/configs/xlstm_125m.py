"""xlstm-125m [ssm] — 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks (xLSTM[7:1]-style mix).  [arXiv:2405.04517; unverified]

d_ff=0: each recurrent block carries its own up/down projection
(proj_factor 2).  sLSTM at positions {1, 7} -> pattern period 6
[m, s, m, m, m, m] repeated twice.

The RID weight compression applies to all projection matrices; the
per-step mLSTM cell update  C_t <- f C_{t-1} + i v k^T  is already rank-1
by construction.  At 1.353e8 parameters (0.54 GB in f32) the port serves
it at full width and depth on one card.  A prompt over 64 tokens must be
a multiple of 64, the mLSTM's chunk (the reference's rule).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_at=(1, 7),
    xlstm_proj_factor=2.0,
)

SMOKE = CONFIG.replace(n_layers=6, d_model=64, n_heads=2, n_kv_heads=2,
                       vocab_size=256, slstm_at=(1,), remat=False)
