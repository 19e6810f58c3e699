"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (backbone only).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191; hf]
Vision frontend is a stub: input_specs() provides precomputed patch
embeddings; M-RoPE runs on the backbone with (t, h, w) position ids.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    m_rope=True,
    m_rope_sections=(16, 24, 24),  # head_dim/2 = 64 split over (t, h, w)
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend="embed",
    tp_strategy="hidden",       # 12 heads not divisible by model axis (16)
    train_grad_accum=2,
)
