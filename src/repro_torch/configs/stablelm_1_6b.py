"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b].

kv=32 == n_heads -> effectively MHA; stablelm-2 uses a parallel
attention+FFN residual block, which we model with ``parallel_block``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    rope_theta=10000.0,
    activation="silu",
    parallel_block=True,
)
