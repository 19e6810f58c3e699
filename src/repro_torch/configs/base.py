"""Architecture configuration (a copy of ``repro.configs.base.ArchConfig``).

Every architecture is a frozen ``ArchConfig``; ``reduced()`` produces the
smoke-test-sized config of the same family (small widths/depths).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | diffusion
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention variants -------------------------------------------------
    attention_kind: str = "full"  # full | swa | none
    window_size: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    m_rope: bool = False
    m_rope_sections: Tuple[int, ...] = ()

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (recurrentgemma / griffin) ------------------------------------
    rglru_ratio: int = 0
    rglru_conv_width: int = 4

    # --- misc -----------------------------------------------------------------
    act: str = "silu"  # silu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    tp_strategy: str = "heads"
    frontend: str = "none"
    train_grad_accum: int = 1
    seq_parallel: bool = False
    kv_quant: bool = False

    # --- diffusion (DiT) ------------------------------------------------------
    is_diffusion: bool = False
    latent_dim: int = 0  # per-token continuous latent dim (DiT patch dim)
    num_classes: int = 0  # class-conditional diffusion

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.rglru_ratio > 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test-sized config of the same family (CPU, 1 device)."""
        changes = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if not self.is_hybrid else 6),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32 if self.head_dim else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window_size=min(self.window_size, 64) if self.window_size else 0,
        )
        if self.is_moe:
            changes.update(num_experts=8, moe_top_k=min(self.moe_top_k, 2),
                           moe_d_ff=64, moe_capacity_factor=8.0)
        if self.is_ssm:
            changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.is_diffusion:
            changes.update(latent_dim=16, num_classes=min(self.num_classes, 16))
        if self.m_rope:
            changes.update(m_rope_sections=(4, 6, 6))
        return dataclasses.replace(self, **changes)
