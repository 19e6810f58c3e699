"""Random weights for a parameter tree, drawn on the device from a seed.

Every random leaf is a view of one flat float32 buffer filled by one
``normal_`` from a ``torch.Generator`` on the device, then scaled in place
by its leaf's standard deviation: lecun leaves N(0, 1/fan_in), normal
leaves N(0, scale^2) (0.02 unless the spec says), zeros leaves named in
``scales`` (by their last key) N(0, scale^2), the other zeros and ones
leaves constant.  The tree's shapes and kinds come from the program's
``ParamSpec`` tree; the values are the benchmark's.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _is_leaf(tree) -> bool:
    return hasattr(tree, "shape")


def _std(path, spec, scales: Dict[str, float]) -> float:
    if spec.init == "lecun":
        return 1.0 / math.sqrt(spec.fan_in)
    if spec.init == "normal":
        return 0.02 if spec.scale is None else float(spec.scale)
    if spec.init == "zeros":
        return float(scales.get(path[-1], 0.0))
    return 0.0


def _children(tree, path):
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    return [(key, value, path + (key,)) for key, value in items]


def draw(defs, seed: int, device, scales: Dict[str, float],
         dtype=torch.float32):
    """The tree of ``defs`` with random values (module docstring)."""
    def numel(tree, path=()):
        if _is_leaf(tree):
            return math.prod(tree.shape) if _std(path, tree, scales) else 0
        return sum(numel(v, p) for _, v, p in _children(tree, path))

    flat = torch.empty(numel(defs), dtype=dtype, device=device)
    flat.normal_(generator=torch.Generator(device=device).manual_seed(
        int(seed)))
    offset = 0

    def build(tree, path=()):
        nonlocal offset
        if not _is_leaf(tree):
            built = {k: build(v, p) for k, v, p in _children(tree, path)}
            return built if isinstance(tree, dict) else list(built.values())
        std = _std(path, tree, scales)
        if not std:
            fill = 1.0 if tree.init == "ones" else 0.0
            return torch.full(tree.shape, fill, dtype=dtype, device=device)
        n = math.prod(tree.shape)
        leaf = flat[offset:offset + n].view(tree.shape).mul_(std)
        offset += n
        return leaf

    return build(defs)
