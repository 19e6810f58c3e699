"""dit-xl [diffusion] — the paper's own denoiser architecture (DiT, Peebles &
Xie 2023): class-conditional latent-diffusion transformer with adaLN-zero.

DiT-XL/2 @ 256x256: 28L d_model=1152 16H d_ff=4608, 32x32x4 latents patchified
at p=2 => 256 tokens of latent_dim=16, 1000 ImageNet classes.  The VAE is a
stub (sampling operates directly in latent space), as in the paper's
sampling experiments.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dit-xl",
    family="diffusion",
    num_layers=28,
    d_model=1152,
    num_heads=16,
    num_kv_heads=16,
    head_dim=72,
    d_ff=4608,
    vocab_size=0,
    act="gelu",
    is_diffusion=True,
    latent_dim=16,              # 2x2 patch of 4-channel latents
    num_classes=1000,
    tp_strategy="heads",
)
