"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242].

81 Mamba2 layers (d_inner = 2*3584, state 64) with a weight-shared
attention+FFN transformer block applied every 6 layers (Zamba2 uses two
alternating shared blocks; we use one, noted in DESIGN.md §7).
Sub-quadratic backbone -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    rope_theta=10000.0,
    activation="gelu",
    ssm=SSMConfig(kind="mamba2", state_dim=64, conv_width=4,
                  expansion=2, head_dim=64, chunk_size=256),
    attn_every=6,
    shared_attn_block=True,
    subquadratic=True,
)
