"""Parameter definitions: one tree of ``ParamSpec`` leaves gives a model's
shapes and inits (the JAX package's ``repro.models.pdefs`` without its
mesh rules, which come with the placement slice).

A params tree is nested dicts keyed as the reference's, so its leaves have
the reference's paths: a JAX tree of numpy arrays converts leaf for leaf
(:func:`params_from_numpy`), and checkpoints cross between the packages.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str         # normal | zeros | ones | lecun (the JAX package's inits)
    fan_in: int = 0   # lecun: the size of the dimensions the weight contracts
    scale: Optional[float] = None   # normal: stddev (None = 0.02)


def stack_defs(defs: Dict, n: int) -> Dict:
    """Prepend a stacked layer axis of size ``n`` to every spec."""
    return {k: stack_defs(v, n) if isinstance(v, dict)
            else v._replace(shape=(n,) + v.shape) for k, v in defs.items()}


def walk(defs: Dict, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, ParamSpec]]:
    """(path, spec) over a defs tree, dict keys sorted (the JAX order)."""
    for key in sorted(defs):
        node = defs[key]
        if isinstance(node, ParamSpec):
            yield prefix + (key,), node
        else:
            yield from walk(node, prefix + (key,))


def param_count(defs: Dict) -> int:
    return int(sum(np.prod(spec.shape) for _, spec in walk(defs)))


def get_path(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def set_path(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def params_from_numpy(defs: Dict, tree, device: DeviceLike = None,
                      dtype=torch.float32, what: str = "param") -> Dict:
    """Nested dict of numpy arrays (the JAX layout) -> nested dict of
    tensors on ``device`` (None = cuda).  Every leaf of ``defs`` must be in
    ``tree`` with its shape; raises on a missing leaf or a wrong shape."""
    dev = resolve_device(device)
    out: Dict = {}
    for path, spec in walk(defs):
        arr = np.asarray(get_path(tree, path))
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"{what} {'/'.join(path)}: shape "
                             f"{tuple(arr.shape)} != {spec.shape}")
        if arr.dtype.name == "bfloat16":     # ml_dtypes bf16 from JAX
            arr = arr.astype(np.float32)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr)              # torch wants a writable buffer
        set_path(out, path, torch.from_numpy(arr).to(device=dev, dtype=dtype))
    return out


def init_numpy(defs: Dict, seed: int,
               zero_scales: Optional[Mapping[str, float]] = None) -> Dict:
    """Random weights from ``np.random.default_rng(seed)``, drawn leaf by
    leaf in path order: lecun = N(0, 1/fan_in) over the dimensions each
    weight contracts, normal = N(0, scale^2), zeros and ones constant.  A
    zeros leaf named in ``zero_scales`` (by its last key) with a scale > 0
    is drawn N(0, scale^2) instead.

    (The JAX initializer takes fan_in as the second-to-last dimension, the
    head count for wq/wk/wv, which saturates the softmax of a random
    model; the port's random weights do not copy that.)"""
    rng = np.random.default_rng(seed)
    zero_scales = zero_scales or {}
    tree: Dict = {}
    for path, spec in walk(defs):
        std = zero_scales.get(path[-1], 0.0) if spec.init == "zeros" else \
            1.0 / np.sqrt(spec.fan_in) if spec.init == "lecun" else \
            (0.02 if spec.scale is None else spec.scale)
        if spec.init == "ones":
            arr = np.ones(spec.shape, np.float32)
        elif std > 0:
            arr = rng.standard_normal(spec.shape, dtype=np.float32)
            arr *= np.float32(std)
        else:
            arr = np.zeros(spec.shape, np.float32)
        set_path(tree, path, arr)
    return tree
