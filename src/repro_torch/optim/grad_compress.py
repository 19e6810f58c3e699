"""Error-feedback gradient compression for the data-parallel all-reduce
(the JAX package's ``repro.optim.grad_compress``, in torch).

Two compressors, both with per-worker error feedback (Karimireddy et al.
2019), so the compression error is re-injected the next step:

  * int8 block quantization: per-block (128) absmax scale, 4x fewer bytes
    on the wire than float32;
  * top-k sparsification: keep the k largest-magnitude entries a tensor.

Usage around the data-parallel all-reduce of a train step:
    g_c, new_err = compress_with_feedback(g, err, cfg)
    all-reduce g_c over the data group, divide by its size
Pure functions of their inputs; off by default.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    kind: str = "int8"  # int8 | topk | none
    block: int = 128
    topk_frac: float = 0.05


def _quant_int8(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 \
        + 1e-12
    # torch.round rounds half to even, as jnp.round
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequant_int8(q, scale, shape):
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress_leaf(g: torch.Tensor, err, cfg: CompressConfig):
    """Returns (dequantized compressed gradient, new error-feedback state).
    The dequantized value is what enters the all-reduce; the int8 payload
    is what would cross the wire (:func:`wire_bytes`)."""
    g32 = g.float() + (err if err is not None else 0.0)
    if cfg.kind == "int8":
        q, scale = _quant_int8(g32, cfg.block)
        deq = _dequant_int8(q, scale, g32.shape)
    elif cfg.kind == "topk":
        k = max(1, int(g32.numel() * cfg.topk_frac))
        flat = g32.reshape(-1)
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        deq = torch.where(torch.abs(flat) >= thresh, flat,
                          torch.zeros_like(flat)).reshape(g32.shape)
    else:
        return g32, torch.zeros_like(g32)
    return deq, g32 - deq


def compress_with_feedback(grads, err_state, cfg: CompressConfig):
    """``compress_leaf`` over a gradient tree (nested dicts/lists) with its
    error-feedback tree (zeros when None)."""
    if cfg.kind == "none":
        return grads, err_state
    if err_state is None:
        err_state = map_tree(lambda g: torch.zeros(g.shape,
                                                   dtype=torch.float32,
                                                   device=g.device), grads)
    deq = map_tree(lambda g, e: compress_leaf(g, e, cfg)[0], grads,
                   err_state)
    err = map_tree(lambda g, e, d: g.float() + e - d, grads, err_state, deq)
    return deq, err


def wire_bytes(grads, cfg: CompressConfig) -> int:
    """Bytes a data-parallel all-reduce would move a step under this
    compression."""
    total = 0
    for g in leaves(grads):
        n = g.numel()
        if cfg.kind == "int8":
            total += n + 4 * (n // cfg.block + 1)
        elif cfg.kind == "topk":
            k = max(1, int(n * cfg.topk_frac))
            total += k * 8  # value + index
        else:
            total += n * 4
    return total
