"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

Backbone only per assignment: the vision frontend is a STUB;
``input_specs()`` provides precomputed patch embeddings (B, 1600, d_model).
Cross-attention layers are inserted every 5th layer (8 of 40).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    activation="silu",
    cross_attn_every=5,
    frontend_seq=1600,
    frontend_dim=4096,
)
