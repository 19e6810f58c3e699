"""DiT and DiffusionWrapper parameters from numpy: the JAX package's param
tree in, the port's dict of tensors out — and numpy-seeded initializers
for random weights.

The JAX tree arrives as nested dicts of numpy arrays (the caller does the
``np.asarray``; nothing here imports jax), stacked leaves on a leading
layer axis.  Every leaf is checked against :func:`dit_defs` (or
:func:`wrapper_defs`).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.diffusion.dit import dit_defs, wrapper_defs
from repro_torch.models.pdefs import init_numpy, params_from_numpy

#: the adaLN-zero leaves (zero-initialized in the reference)
ADA_ZERO = ("ada", "final_ada", "out_proj")


def dit_params_from_numpy(tree, cfg: ArchConfig, device: DeviceLike = None,
                          dtype=torch.float32) -> Dict:
    """Nested dict of numpy arrays (JAX layout) -> nested dict of tensors on
    ``device`` (None = cuda).  Raises on a missing leaf or a wrong shape."""
    return params_from_numpy(dit_defs(cfg), tree, device, dtype, "DiT param")


def dit_init_numpy(cfg: ArchConfig, seed: int, *,
                   ada_scale: float = 0.0) -> Dict:
    """Random DiT weights from ``np.random.default_rng(seed)``
    (:func:`repro_torch.models.pdefs.init_numpy`: lecun over the contracted
    dimensions, normal N(0, 0.02^2)).  The adaLN-zero leaves are zeros, as
    in the reference, unless ``ada_scale`` > 0 makes them N(0,
    ada_scale^2) — with zeros eps is identically 0 and the transformer
    never shapes the output."""
    return init_numpy(dit_defs(cfg), seed,
                      {name: ada_scale for name in ADA_ZERO})


def dit_init(cfg: ArchConfig, seed: int, device: DeviceLike = None, *,
             ada_scale: float = 0.0, dtype=torch.float32) -> Dict:
    """Random DiT parameters on ``device`` (see :func:`dit_init_numpy`)."""
    return dit_params_from_numpy(dit_init_numpy(cfg, seed,
                                                ada_scale=ada_scale),
                                 cfg, device, dtype)


def wrapper_params_from_numpy(tree, cfg: ArchConfig, latent_dim: int,
                              device: DeviceLike = None,
                              dtype=torch.float32) -> Dict:
    """The JAX package's wrapper tree (``wrapper_defs``) -> tensors on
    ``device`` (None = cuda), every leaf checked."""
    return params_from_numpy(wrapper_defs(cfg, latent_dim), tree, device,
                             dtype, "wrapper param")


def wrapper_init_numpy(cfg: ArchConfig, latent_dim: int, seed: int, *,
                       out_scale: float = 0.0) -> Dict:
    """Random wrapper weights from ``np.random.default_rng(seed)``.
    ``out_proj`` is zeros, as in the reference (eps = 0: ParaTAA converges
    in one iteration), unless ``out_scale`` > 0 makes it N(0,
    out_scale^2)."""
    return init_numpy(wrapper_defs(cfg, latent_dim), seed,
                      {"out_proj": out_scale})


def wrapper_init(cfg: ArchConfig, latent_dim: int, seed: int,
                 device: DeviceLike = None, *, out_scale: float = 0.0,
                 dtype=torch.float32) -> Dict:
    """Random wrapper parameters on ``device`` (see
    :func:`wrapper_init_numpy`)."""
    return wrapper_params_from_numpy(
        wrapper_init_numpy(cfg, latent_dim, seed, out_scale=out_scale),
        cfg, latent_dim, device, dtype)
