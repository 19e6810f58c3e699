"""Plain Mamba2 latent denoiser: a Mamba2 trunk (Dao & Gu 2024,
arXiv:2405.21060) between a latent projection with an added timestep
embedding and an output projection, written from its definition in plain
PyTorch.

Each layer is h + Mamba2(RMSNorm(h)).  A Mamba2 block projects to z, x,
B, C and dt; x, B and C pass a causal depthwise convolution of width W
(no bias) and SiLU; dt = softplus(dt_raw + dt_bias), A = -exp(A_log); the
SSD layer is computed in its dual, quadratic form (the paper's section 4,
"state space duality"):

    y_i = sum_{j <= i} (C_i . B_j) exp(sum_{k=j+1..i} dt_k A) dt_j x_j + D x_i

per head, one group of B and C shared by every head; then y is gated,
RMSNorm(y * silu(z)), and projected out.  A last RMSNorm closes the
trunk.  The norms' epsilon is the program's 1e-6 (the published
checkpoint's is 1e-5); the trunk's embedding and head are not used.

``dtype`` is the precision of the projections (and the activations
between layers); the convolution, the SSD and the norms run in float32
whatever it is, as the program's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.shared import timestep_embedding


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    y = xf / torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); kernel: (W, C): out_s = sum_i kernel_i x_{s-W+1+i},
    zeros before the start.  In float32."""
    w = kernel.shape[0]
    xp = F.pad(x.float().transpose(1, 2), (w - 1, 0))
    out = F.conv1d(xp, kernel.float().t()[:, None, :], groups=x.shape[2])
    return out.transpose(1, 2)


def ssd(x, dt, A, B, C, D):
    """x: (b, s, h, p); dt: (b, s, h); A, D: (h,); B, C: (b, s, n).
    The quadratic form, float32.  Returns (b, s, h, p)."""
    s = x.shape[1]
    cum = torch.cumsum(dt * A, dim=1)                        # (b, s, h)
    seg = cum.transpose(1, 2)[..., :, None] - cum.transpose(1, 2)[..., None, :]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))  # (b,h,i,j)
    cb = C @ B.transpose(1, 2)                                # (b, i, j)
    weights = cb[:, None] * decay                             # (b,h,i,j)
    xdt = (x * dt[..., None]).transpose(1, 2)                 # (b,h,j,p)
    y = (weights @ xdt).transpose(1, 2)                       # (b,i,h,p)
    return y + x * D[None, None, :, None]


def mamba_block(p, conf: dict, u: torch.Tensor, dtype) -> torch.Tensor:
    b, s, _ = u.shape
    hd = conf["headdim"]
    heads = conf["expand"] * conf["d_model"] // hd
    z = u @ p["in_z"].to(dtype)
    xs = F.silu(causal_conv(u @ p["in_x"].to(dtype), p["conv_x"]))
    Bm = F.silu(causal_conv(u @ p["in_B"].to(dtype), p["conv_B"]))
    Cm = F.silu(causal_conv(u @ p["in_C"].to(dtype), p["conv_C"]))
    dt = F.softplus((u @ p["in_dt"].to(dtype)).float()
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y = ssd(xs.reshape(b, s, heads, hd), dt, A, Bm, Cm, p["D"].float())
    y = y.reshape(b, s, heads * hd)
    y = rms_norm(y * F.silu(z.float()), p["norm"]["scale"]).to(dtype)
    return y @ p["out"].to(dtype)


def eps(params, conf: dict, x: torch.Tensor, t: torch.Tensor, y=None,
        dtype=torch.float32) -> torch.Tensor:
    """eps prediction.  x: (B, N, latent) float32; t: (B,) float
    timesteps; ``y`` is ignored (the denoiser is unconditional).
    Returns (B, N, latent) float32."""
    h = x.to(dtype) @ params["in_proj"].to(dtype)
    temb = timestep_embedding(t).to(dtype)
    cond = F.silu(temb @ params["t_mlp1"].to(dtype)) \
        @ params["t_mlp2"].to(dtype)
    h = h + cond[:, None, :]
    layers = params["backbone"]["layers"]
    for i in range(conf["n_layer"]):
        p = {k: v[i] for k, v in layers["mamba"].items() if k != "norm"}
        p["norm"] = {"scale": layers["mamba"]["norm"]["scale"][i]}
        h = h + mamba_block(p, conf,
                            rms_norm(h, layers["norm"]["scale"][i]), dtype)
    h = rms_norm(h, params["backbone"]["final_norm"]["scale"])
    return (h @ params["out_proj"].to(dtype)).float()
