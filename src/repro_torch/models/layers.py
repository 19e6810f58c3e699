"""Common layers: norms, gated MLP, RoPE / M-RoPE, timestep and position
embeddings (the JAX package's ``models/layers.py`` counterparts)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import constant, to_device
from repro_torch.models.pdefs import ParamSpec


def rmsnorm_def(d: int):
    return {"scale": ParamSpec((d,), "ones", axes=("norm",))}


def rmsnorm(params, x, eps: float = 1e-6, group=None, width: int = 0):
    """RMSNorm over the last axis, in float32.  With ``group``, ``x`` holds
    this rank's block of a last axis of ``width`` split over the group
    (and ``params["scale"]`` the matching block): the sum of squares is
    all-reduced over it in float32 (each rank then normalizes its block,
    so the backward all-reduces the sum's partial gradients)."""
    dt = x.dtype
    x = x.float()
    if group is None:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        from repro_torch import comm

        var = comm.sum_partial(x.square().sum(dim=-1, keepdim=True),
                               group) / width
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_noaffine(x, eps: float = 1e-6):
    """LayerNorm without affine parameters, in float32: population
    variance, eps inside the rsqrt."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


def mlp_def(d: int, ff: int):
    """Gated MLP (SwiGLU / GeGLU)."""
    return {"wi_gate": ParamSpec((d, ff), "lecun", d,
                                  axes=("embed", "mlp")),
            "wi_up": ParamSpec((d, ff), "lecun", d,
                                axes=("embed", "mlp")),
            "wo": ParamSpec((ff, d), "lecun", ff, axes=("mlp", "embed"))}


def mlp(params, x, act: str = "silu"):
    """Gated MLP (SwiGLU / GeGLU): (act(x W_gate) * x W_up) W_o.  Given a
    model rank's blocks (``wi_gate``/``wi_up`` its columns, ``wo`` its
    rows) it returns that rank's partial sum: the caller adds the partials
    over ``model`` (``ShardedParams.model_sum``)."""
    g = act_fn(act)(x @ params["wi_gate"])
    return (g * (x @ params["wi_up"])) @ params["wo"]


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def _freqs(d: int, theta: float, device) -> torch.Tensor:
    """The (d/2,) float32 RoPE frequencies on ``device``, made once (no
    host copy per call: decode runs under sync-debug mode on the card)."""
    return constant(("rope_freqs", d, theta, torch.device(device)),
                    lambda: to_device(rope_freqs(d, theta), torch.float32,
                                      device))


def _rotate(x, ang):
    """x: (B, S, H, D); ang: (B, S, D/2) float32 -> x rotated (halves
    layout), in x's dtype."""
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = _freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions.float()[..., None] * freqs)


def apply_m_rope(x, positions3, theta: float, sections):
    """M-RoPE (qwen2-vl): positions3 (3, B, S) for (t, h, w); ``sections``
    sums to head_dim // 2, each section rotates with its own position
    stream."""
    d = x.shape[-1]
    freqs = _freqs(d, theta, x.device)
    sec_id = constant(
        ("m_rope_sections", tuple(sections), torch.device(x.device)),
        lambda: to_device(np.repeat(np.arange(len(sections)), sections),
                          torch.long, x.device))
    pos = positions3.float()[sec_id]                  # (d/2, B, S)
    return _rotate(x, pos.movedim(0, -1) * freqs)


def sinusoidal_embed(t, dim: int, max_period: float = 10_000.0):
    """t: (B,) float -> (B, dim): cos then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def sincos_positions(n: int, dim: int) -> np.ndarray:
    """Fixed 1-D sincos position table (n, dim): sin then cos, built in
    float64 numpy and returned as float32."""
    half = dim // 2
    freqs = np.exp(-np.log(10_000.0) * np.arange(half) / half)
    ang = np.arange(n)[:, None] * freqs[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)
