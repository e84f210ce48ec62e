"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

671B total / ~37B active. First 3 layers use a dense FFN (d_ff 18432);
remaining 58 are MoE with 256 routed experts (top-8) + 1 shared expert,
expert d_ff 2048. MLA: q_lora 1536, kv_lora 512, rope 64, nope 128, v 128.
MTP depth 1. Too large to replicate params per TP group -> fsdp=True and
bf16 optimizer moments (memory math in EXPERIMENTS.md).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    head_dim=128,
    rope_theta=10000.0,
    activation="silu",
    use_mla=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, expert_d_ff=2048,
                  n_shared_experts=1, n_dense_layers=3, dense_d_ff=18432,
                  capacity_factor=1.25, expert_parallel=True),
    mtp_depth=1,
    fsdp=True,
    param_dtype="bfloat16",   # bf16 master (+bf16 moments): 671B cannot hold
    opt_state_dtype="bfloat16",  # fp32 Adam state on the reference's cluster
)
