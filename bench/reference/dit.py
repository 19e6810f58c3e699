"""Plain DiT forward (Peebles & Xie 2023, arXiv:2212.09748): the
class-conditional latent transformer with adaLN-zero, written from its
definition in plain PyTorch, no kernel, cache or batching trick.

It reads the parameter tree the benchmark draws (the layout the program
takes: ``wq`` (L, d, H, hd), ``wo`` (L, H, hd, d), blocks stacked on a
leading layer axis) and computes eps from it.  Where the program's DiT
departs from the paper, this follows the program, and says so:

* the MLP is gated, (gelu(h W_gate) * h W_up) W_o, where the paper's is
  gelu(h W_1) W_2; GELU is the tanh approximation, as the paper's;
* positions are a 1-D sin-then-cos table over the token index, where the
  paper's is 2-D over the patch grid;
* the timestep embedding is cos-then-sin over 256 frequencies, as the
  paper's, and the class embedding has one extra row (the null class).

``dtype`` is the precision of the products and the activations between
them; the norms, the softmax and the positions are taken in float32 and
float64 whatever it is.  Called with float32 and TF32 off
(``shared.exact_float32``) it is the reference; with bfloat16 it is the
precision control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.shared import timestep_embedding


def positions(n: int, dim: int, device) -> torch.Tensor:
    """(n, dim) float32: sin then cos of index * 10000^(-i/half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float64, device=device) / half)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters, in float32, back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def attention(h, wq, wk, wv, wo, dtype):
    """Full (non-causal) multi-head attention, softmax in float32."""
    b, n, d = h.shape
    _, H, hd = wq.shape
    q = (h @ wq.reshape(d, H * hd).to(dtype)).reshape(b, n, H, hd)
    k = (h @ wk.reshape(d, H * hd).to(dtype)).reshape(b, n, H, hd)
    v = (h @ wv.reshape(d, H * hd).to(dtype)).reshape(b, n, H, hd)
    q, k, v = (z.permute(0, 2, 1, 3) for z in (q, k, v))    # (b, H, n, hd)
    scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    ctx = (probs @ v).permute(0, 2, 1, 3).reshape(b, n, H * hd)
    return ctx @ wo.reshape(H * hd, d).to(dtype)


def eps(params, conf: dict, x: torch.Tensor, t: torch.Tensor,
        y: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """eps prediction.  x: (B, N, latent) float32; t: (B,) float
    timesteps; y: (B,) int labels.  Returns (B, N, latent) float32."""
    def w(leaf):
        return leaf.to(dtype)

    b, n, _ = x.shape
    d = conf["hidden_size"]
    h = x.to(dtype) @ w(params["in_proj"])
    h = h + positions(n, d, x.device).to(dtype)[None]
    temb = timestep_embedding(t).to(dtype)
    cond = F.silu(temb @ w(params["t_mlp1"])) @ w(params["t_mlp2"])
    cond = F.silu(cond + w(params["y_embed"])[y.long()])
    blocks = params["blocks"]
    for i in range(conf["depth"]):
        mod = cond @ w(blocks["ada"][i])
        s1, sc1, g1, s2, sc2, g2 = mod.chunk(6, dim=-1)
        a = attention(modulate(layer_norm(h), s1, sc1), blocks["wq"][i],
                      blocks["wk"][i], blocks["wv"][i], blocks["wo"][i],
                      dtype)
        h = h + g1[:, None, :] * a
        m = modulate(layer_norm(h), s2, sc2)
        mlp = blocks["mlp"]
        gate = F.gelu(m @ w(mlp["wi_gate"][i]), approximate="tanh")
        h = h + g2[:, None, :] * ((gate * (m @ w(mlp["wi_up"][i])))
                                  @ w(mlp["wo"][i]))
    sh, sc = (cond @ w(params["final_ada"])).chunk(2, dim=-1)
    return (modulate(layer_norm(h), sh, sc) @ w(params["out_proj"])).float()
