"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    rope_theta=999999.4,
    activation="gelu",
    tie_embeddings=True,
    # 24 heads do not divide 16 lanes: pad to 32 with output-masked dead
    # heads (model-equivalent incl. grads) so attention TP-shards — §Perf
    pad_heads_to=32,
)
