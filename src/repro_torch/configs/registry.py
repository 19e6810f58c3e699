"""--arch lookup: maps architecture ids to their configs (the JAX
package's ``repro.configs.registry``)."""
from __future__ import annotations

from repro_torch.configs import (dit_xl, granite_8b, h2o_danube_3_4b,
                                 mamba2_1_3b, moonshot_v1_16b_a3b,
                                 musicgen_medium, qwen2_72b, qwen2_moe_a2_7b,
                                 qwen2_vl_2b, qwen3_0_6b, recurrentgemma_2b)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

ARCHS = {
    cfg.name: cfg
    for cfg in [
        recurrentgemma_2b.CONFIG,
        musicgen_medium.CONFIG,
        qwen3_0_6b.CONFIG,
        granite_8b.CONFIG,
        qwen2_72b.CONFIG,
        h2o_danube_3_4b.CONFIG,
        mamba2_1_3b.CONFIG,
        moonshot_v1_16b_a3b.CONFIG,
        qwen2_moe_a2_7b.CONFIG,
        qwen2_vl_2b.CONFIG,
        dit_xl.CONFIG,
    ]
}

# The ten assigned LM-family architectures (dit-xl is the paper's own extra).
ASSIGNED = [n for n in ARCHS if n != "dit-xl"]


def get_arch(name: str) -> ArchConfig:
    key = name.replace("_", "-").lower()
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells():
    """Every (arch, shape) cell, with skip reasons for inapplicable ones."""
    cells = []
    for arch_name in ASSIGNED:
        arch = ARCHS[arch_name]
        for shape in SHAPES.values():
            ok, reason = arch.supports_shape(shape)
            cells.append((arch, shape, ok, reason))
    return cells
