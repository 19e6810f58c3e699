"""DiT (Peebles & Xie 2023) — the paper's own denoiser — as plain functions
on a dict of tensors.

Class-conditional latent transformer with adaLN-zero conditioning.  The
VAE/patchify frontend is a stub: inputs are (B, N, latent_dim) latent
tokens, the space the paper's sampling experiments operate in.

Parameters keep the JAX package's layouts (``wq`` (d, H, hd), ``wo``
(H, hd, d), blocks stacked on a leading layer axis), so the JAX param tree
converts leaf for leaf (:mod:`repro_torch.diffusion.convert`).  The large
products stay ``torch.matmul``/``einsum``, as the JAX package leaves them
to XLA.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import constant, to_device
from repro_torch.models.layers import (layernorm_noaffine, mlp,
                                       sincos_positions, sinusoidal_embed)

TEMB_DIM = 256


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str         # normal | zeros | lecun (the JAX package's inits)
    fan_in: int = 0   # lecun: the size of the dimensions the weight contracts


def dit_defs(cfg: ArchConfig) -> Dict:
    """The DiT's parameter tree (shapes + inits), blocks stacked on a
    leading layer axis — the shapes of the JAX package's ``dit_defs``."""
    d, ff, H, hd, L = (cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim,
                       cfg.num_layers)
    block = {
        "ada": ParamSpec((L, d, 6 * d), "zeros"),
        "wq": ParamSpec((L, d, H, hd), "lecun", d),
        "wk": ParamSpec((L, d, H, hd), "lecun", d),
        "wv": ParamSpec((L, d, H, hd), "lecun", d),
        "wo": ParamSpec((L, H, hd, d), "lecun", H * hd),
        "mlp": {"wi_gate": ParamSpec((L, d, ff), "lecun", d),
                "wi_up": ParamSpec((L, d, ff), "lecun", d),
                "wo": ParamSpec((L, ff, d), "lecun", ff)},
    }
    return {
        "in_proj": ParamSpec((cfg.latent_dim, d), "lecun", cfg.latent_dim),
        "t_mlp1": ParamSpec((TEMB_DIM, d), "lecun", TEMB_DIM),
        "t_mlp2": ParamSpec((d, d), "lecun", d),
        "y_embed": ParamSpec((cfg.num_classes + 1, d), "normal"),
        "blocks": block,
        "final_ada": ParamSpec((d, 2 * d), "zeros"),
        "out_proj": ParamSpec((d, cfg.latent_dim), "zeros"),
    }


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _dit_attention(p, x):
    """Full (non-causal) attention, scores and softmax in float32.
    x: (B, N, d); p["wq"|"wk"|"wv"] (d, H, hd); p["wo"] (H, hd, d)."""
    b, n, d = x.shape
    _, H, hd = p["wq"].shape

    def heads(w):
        return (x @ w.reshape(d, H * hd)).reshape(b, n, H, hd)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    scores = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float())
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
    ctx = torch.einsum("bhnm,bmhk->bnhk", probs, v.float()).to(x.dtype)
    return ctx.reshape(b, n, H * hd) @ p["wo"].reshape(H * hd, d)


def _positions(n: int, d: int, dtype, device) -> torch.Tensor:
    """The (n, d) sincos position table on ``device``, made once per (n, d,
    dtype, device) from the same numpy values, so no call copies it from
    the host."""
    return constant(("dit_positions", n, d, dtype, torch.device(device)),
                    lambda: to_device(sincos_positions(n, d), dtype, device))


def dit_apply(params, cfg: ArchConfig, latents, t, y=None):
    """eps prediction.  latents: (B, N, latent_dim); t: (B,) float
    timesteps; y: (B,) int class labels (None -> the null class)."""
    b, n, _ = latents.shape
    d = cfg.d_model
    x = latents @ params["in_proj"]
    x = x + _positions(n, d, x.dtype, x.device)[None]

    temb = sinusoidal_embed(t, TEMB_DIM).to(x.dtype)
    cond = F.silu(temb @ params["t_mlp1"]) @ params["t_mlp2"]
    if y is None:
        y = torch.full((b,), cfg.num_classes, dtype=torch.long,
                       device=x.device)                       # null class
    cond = F.silu(cond + params["y_embed"][y])

    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        p = {k: v[i] for k, v in blocks.items() if k != "mlp"}
        p_mlp = {k: v[i] for k, v in blocks["mlp"].items()}
        s1, sc1, g1, s2, sc2, g2 = (cond @ p["ada"]).chunk(6, dim=-1)
        h = _dit_attention(p, _modulate(layernorm_noaffine(x), s1, sc1))
        x = x + g1[:, None, :] * h
        h = mlp(p_mlp, _modulate(layernorm_noaffine(x), s2, sc2), "gelu")
        x = x + g2[:, None, :] * h
    sh, sc = (cond @ params["final_ada"]).chunk(2, dim=-1)
    x = _modulate(layernorm_noaffine(x), sh, sc)
    return x @ params["out_proj"]
