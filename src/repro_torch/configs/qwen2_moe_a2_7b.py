"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  Note: 60 routed experts are padded to 64
(zero-routed dead experts) for expert-parallel sharding over the 16-way model
axis; routing logits for pad experts are masked to -inf, so the function is
exactly the 60-expert model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    num_experts=60,
    num_shared_experts=4,
    moe_top_k=4,
    moe_d_ff=1408,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    train_grad_accum=4,
)
