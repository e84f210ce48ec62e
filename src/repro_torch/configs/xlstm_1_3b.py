"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

Implemented as mLSTM blocks (the dominant, matrix-memory block in the 1.3B
xLSTM[7:1] config): up-projection 2x, 4 heads, exponential input/forget
gating, chunked linear-attention scan. d_ff=0 per spec (no separate FFN;
the mLSTM block embeds its own projections). Sub-quadratic -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    ssm=SSMConfig(kind="mlstm", expansion=2, qk_dim_factor=0.5,
                  head_dim=512, chunk_size=256),
    subquadratic=True,
)
