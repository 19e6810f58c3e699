"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    attention_kind="swa",       # local attention blocks use a sliding window
    window_size=2048,
    rglru_ratio=3,              # layers 2, 5, 8, ... are local-attn; rest RG-LRU
    act="gelu",
    tie_embeddings=True,
    logit_softcap=30.0,
    tp_strategy="hidden",       # 10 heads not divisible by model axis (16)
    train_grad_accum=2,
)
