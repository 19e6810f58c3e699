"""--arch lookup.  The port serves the paper's own denoiser only."""
from __future__ import annotations

from repro_torch.configs import dit_xl
from repro_torch.configs.base import ArchConfig

ARCHS = {dit_xl.CONFIG.name: dit_xl.CONFIG}


def get_arch(name: str) -> ArchConfig:
    key = name.replace("_", "-").lower()
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]
