"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24, i.e. MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf].  EnCodec frontend is a stub: input_specs() provides
precomputed frame embeddings (B, S, d_model); the vocab head predicts the
2048-entry codebook.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    frontend="embed",
    tp_strategy="hidden",       # 24 heads not divisible by model axis (16)
    train_grad_accum=2,
)
