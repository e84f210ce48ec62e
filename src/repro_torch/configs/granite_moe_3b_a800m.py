"""granite-moe-3b-a800m [moe] — [hf:ibm-granite].

NOTE: the assignment line says "MoE 40e top-8" while its free-text comment
says "32 experts"; we implement the structured spec (40 experts, top-8).
40 experts do not divide the 16-lane model axis -> expert-TP (shard each
expert's d_ff) instead of EP; see DESIGN.md §7.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    rope_theta=10000.0,
    activation="silu",
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512,
                  n_shared_experts=0, n_dense_layers=0,
                  capacity_factor=1.25, expert_parallel=False,
                  # pad the expert table to 48 (router-masked dead
                  # experts, model-equivalent) so expert parallelism
                  # divides a 16-way model axis
                  pad_experts_to=48),
    tie_embeddings=True,
    pad_heads_to=32,   # 24 heads -> 32 (see starcoder2 note)
)
