"""LM backbone parameters from numpy: the JAX package's param tree in
(``repro.models.backbone.build_defs`` layout, nested dicts and lists of
numpy arrays), the port's tree of tensors out, every leaf checked — and
random weights, numpy-seeded or drawn on the card."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.backbone import build_defs
from repro_torch.models.pdefs import (init_numpy, init_on_device,
                                      params_from_numpy)


def backbone_params_from_numpy(tree, cfg: ArchConfig,
                               device: DeviceLike = None,
                               dtype=torch.float32) -> Dict:
    """Nested dicts/lists of numpy arrays (JAX layout) -> tensors on
    ``device`` (None = cuda), in ``dtype`` but for the leaves that keep
    their own (float32 SSM decays, ``lam``, the router).  Raises on a
    missing leaf or a wrong shape."""
    return params_from_numpy(build_defs(cfg), tree, device, dtype,
                             "backbone param")


def backbone_init_numpy(cfg: ArchConfig, seed: int) -> Dict:
    """Random backbone weights from ``np.random.default_rng(seed)``
    (:func:`repro_torch.models.pdefs.init_numpy`: lecun over the contracted
    dimensions, the embedding N(0, 1/d), norms ones, biases zeros)."""
    return init_numpy(build_defs(cfg), seed)


def backbone_init(cfg: ArchConfig, seed: int, device: DeviceLike = None, *,
                  dtype=torch.float32) -> Dict:
    """Random backbone parameters on ``device`` (see
    :func:`backbone_init_numpy`)."""
    return backbone_params_from_numpy(backbone_init_numpy(cfg, seed), cfg,
                                      device, dtype)


def backbone_init_on_device(cfg: ArchConfig, seed: int,
                            device: DeviceLike = None, *,
                            dtype=torch.bfloat16) -> Dict:
    """Random backbone parameters drawn on ``device`` from a seeded
    ``torch.Generator`` (:func:`repro_torch.models.pdefs.init_on_device`:
    the distributions of :func:`backbone_init_numpy`, not its values), with
    no host copy: for full-width models too large for the numpy path
    (qwen2-moe-a2.7b's float32 numpy tree would be ~60 GB)."""
    return init_on_device(build_defs(cfg), seed, device, dtype)
