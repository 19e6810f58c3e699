"""LM backbone parameters from numpy: the JAX package's param tree in
(``repro.models.backbone.build_defs`` layout, nested dicts of numpy
arrays), the port's dict of tensors out, every leaf checked — and a
numpy-seeded initializer for random weights."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.backbone import build_defs
from repro_torch.models.pdefs import init_numpy, params_from_numpy


def backbone_params_from_numpy(tree, cfg: ArchConfig,
                               device: DeviceLike = None,
                               dtype=torch.float32) -> Dict:
    """Nested dict of numpy arrays (JAX layout) -> tensors on ``device``
    (None = cuda).  Raises on a missing leaf or a wrong shape."""
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
