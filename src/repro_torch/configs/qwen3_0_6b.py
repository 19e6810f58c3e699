"""qwen3-0.6b [dense] — qk_norm, GQA, decoupled head_dim.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936 head_dim=128
[hf:Qwen/Qwen3-8B family; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,               # decoupled from d_model/num_heads in qwen3
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    train_grad_accum=2,
)
