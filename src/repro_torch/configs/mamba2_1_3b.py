"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 vocab=50280 ssm_state=128 [arXiv:2405.21060; unverified]
d_inner = 2*d_model = 4096, head_dim 64 => 64 SSD heads.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attention_kind="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv_width=4,
    ssm_ngroups=1,
    tie_embeddings=True,
    tp_strategy="hidden",
    train_grad_accum=4,
)
