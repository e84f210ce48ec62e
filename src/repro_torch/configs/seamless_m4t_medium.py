"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

Backbone only per assignment: the audio frontend is a STUB;
``input_specs()`` provides precomputed frame embeddings (B, T, 1024).
12 encoder + 12 decoder layers with cross-attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    activation="gelu",
    is_encoder_decoder=True,
    n_encoder_layers=12,
    frontend_seq=512,
    frontend_dim=1024,
)
