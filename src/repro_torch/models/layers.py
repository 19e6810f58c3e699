"""The layers the DiT uses: norm, gated MLP, timestep and position
embeddings (the JAX package's ``models/layers.py`` counterparts)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


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


def mlp(params, x, act: str = "silu"):
    """Gated MLP (SwiGLU / GeGLU): (act(x W_gate) * x W_up) W_o."""
    g = act_fn(act)(x @ params["wi_gate"])
    return (g * (x @ params["wi_up"])) @ params["wo"]


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
