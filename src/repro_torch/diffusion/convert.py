"""DiT parameters from numpy: the JAX package's param tree in, the port's
dict of tensors out — and a numpy-seeded initializer for random weights.

The JAX tree arrives as nested dicts of numpy arrays (the caller does the
``np.asarray``; nothing here imports jax), ``blocks`` stacked on a leading
layer axis.  Every leaf is checked against :func:`dit_defs`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion.dit import ParamSpec, dit_defs

#: the adaLN-zero leaves (zero-initialized in the reference)
ADA_ZERO = ("ada", "final_ada", "out_proj")


def _walk(defs: Dict, prefix=()):
    for key in sorted(defs):
        node = defs[key]
        if isinstance(node, ParamSpec):
            yield prefix + (key,), node
        else:
            yield from _walk(node, prefix + (key,))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def dit_params_from_numpy(tree, cfg: ArchConfig, device: DeviceLike = None,
                          dtype=torch.float32) -> Dict:
    """Nested dict of numpy arrays (JAX layout) -> nested dict of tensors on
    ``device`` (None = cuda).  Raises on a missing leaf or a wrong shape."""
    dev = resolve_device(device)
    out: Dict = {}
    for path, spec in _walk(dit_defs(cfg)):
        arr = np.asarray(_get(tree, path))
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"DiT param {'/'.join(path)}: shape "
                             f"{tuple(arr.shape)} != {spec.shape}")
        if arr.dtype.name == "bfloat16":     # ml_dtypes bf16 from JAX
            arr = arr.astype(np.float32)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr)              # torch wants a writable buffer
        _set(out, path, torch.from_numpy(arr).to(device=dev, dtype=dtype))
    return out


def dit_init_numpy(cfg: ArchConfig, seed: int, *,
                   ada_scale: float = 0.0) -> Dict:
    """Random DiT weights from ``np.random.default_rng(seed)``: lecun =
    N(0, 1/fan_in) over the dimensions each weight contracts, normal =
    N(0, 0.02^2).  (The JAX initializer takes fan_in as the second-to-last
    dimension, the head count for wq/wk/wv, which saturates the softmax of
    a random DiT and makes it chaotic; the port's random weights do not
    copy that.)  The adaLN-zero leaves are zeros, as in the reference,
    unless ``ada_scale`` > 0 makes them N(0, ada_scale^2) — with zeros eps
    is identically 0 and the transformer never shapes the output."""
    rng = np.random.default_rng(seed)
    tree: Dict = {}
    for path, spec in _walk(dit_defs(cfg)):
        if spec.init == "zeros" and not (ada_scale > 0
                                         and path[-1] in ADA_ZERO):
            arr = np.zeros(spec.shape, np.float32)
        else:
            if spec.init == "zeros":
                std = ada_scale
            elif spec.init == "lecun":
                std = 1.0 / np.sqrt(spec.fan_in)
            else:
                std = 0.02
            arr = rng.standard_normal(spec.shape, dtype=np.float32)
            arr *= np.float32(std)
        _set(tree, path, arr)
    return tree


def dit_init(cfg: ArchConfig, seed: int, device: DeviceLike = None, *,
             ada_scale: float = 0.0, dtype=torch.float32) -> Dict:
    """Random DiT parameters on ``device`` (see :func:`dit_init_numpy`)."""
    return dit_params_from_numpy(dit_init_numpy(cfg, seed,
                                                ada_scale=ada_scale),
                                 cfg, device, dtype)
