"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 routed experts top-6.

48L d_model=2048 16H (GQA kv=16, i.e. MHA) per-expert d_ff=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=163_840,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    rope_theta=50_000.0,
    train_grad_accum=4,
)
