"""Griffin recurrent block with RG-LRU (recurrentgemma): the JAX package's
``repro.models.rglru``.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t), with the per-channel
decay a_t = exp(-c * softplus(Lambda) * r_t) and sigmoid gates r, i from
block-diagonal projections of the conv output.

The reference scans the recurrence with ``jax.lax.associative_scan``;
here it is a Hillis-Steele scan of whole-tensor ops, ceil(log2 S) passes
(another association order: float32 results agree within rounding, not
bit for bit).  Prefill and decode write the cache in place, as
``models.mamba2`` does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import act_fn
from repro_torch.models.mamba2 import _causal_conv
from repro_torch.models.pdefs import ParamSpec

RGLRU_C = 8.0
NUM_GATE_BLOCKS = 8


def rglru_def(cfg: ArchConfig):
    d = cfg.d_model  # lru width == d_model
    nb = NUM_GATE_BLOCKS
    bs = d // nb
    w = cfg.rglru_conv_width
    return {
        "w_y": ParamSpec((d, d), "lecun", d, axes=("embed", "inner")),
        "w_x": ParamSpec((d, d), "lecun", d, axes=("embed", "inner")),
        "conv": ParamSpec((w, d), "lecun", w, axes=("conv", "inner")),
        "w_a": ParamSpec((nb, bs, bs), "lecun", bs,
                         axes=(None, None, "inner")),
        "w_i": ParamSpec((nb, bs, bs), "lecun", bs,
                         axes=(None, None, "inner")),
        "b_a": ParamSpec((d,), "zeros", axes=("inner",)),
        "b_i": ParamSpec((d,), "zeros", axes=("inner",)),
        "lam": ParamSpec((d,), "normal", scale=0.5, dtype=torch.float32,
                         axes=("inner",)),
        "w_o": ParamSpec((d, d), "lecun", d, axes=("inner", "embed")),
    }


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype, device):
    d, w = cfg.d_model, cfg.rglru_conv_width
    return {
        "state": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, w - 1, d), dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def _block_diag(x, w, b):
    """x: (..., d); w: (nb, bs, bs) -> (..., d), in x's dtype."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    y = torch.einsum("...nk,nkj->...nj", xs, w)
    return y.reshape(x.shape) + b


def _rglru_gates(params, u):
    """u: (B, S, d) conv output -> (a, b_term), both float32."""
    r = torch.sigmoid(_block_diag(u, params["w_a"], params["b_a"]).float())
    i = torch.sigmoid(_block_diag(u, params["w_i"], params["b_i"]).float())
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r        # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * u.float()
    return a, b


def rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = h0, or 0): a
    Hillis-Steele scan, each pass combining every step with the one
    ``shift`` before it, (a1, b1) then (a2, b2) -> (a1 a2, b1 a2 + b2)."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift], b[:, shift:] + a[:, shift:]
                       * b[:, :-shift]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    if h0 is not None:
        b = b + a * h0[:, None, :]
    return b


def rglru_apply(params, cfg: ArchConfig, x, *, mode: str = "train",
                cache: Optional[dict] = None):
    """Griffin recurrent block.  x: (B, S, d) -> (y, cache).  Prefill and
    decode write ``cache`` in place and return it."""
    y_branch = act_fn("gelu")(x @ params["w_y"])
    u = x @ params["w_x"]
    u, new_conv = _causal_conv(u, params["conv"],
                               cache["conv"] if cache is not None else None)
    a, b = _rglru_gates(params, u)

    if mode == "decode":
        if x.shape[1] != 1 or cache is None:
            raise ValueError("decode takes one token and a cache")
        h = a[:, 0] * cache["state"] + b[:, 0]               # (B, d)
        cache["state"].copy_(h)
        cache["index"].add_(1)
        h = h[:, None]
    else:
        h = rglru_scan(a, b, cache["state"] if cache is not None else None)
        if mode == "prefill" and cache is not None:
            cache["state"].copy_(h[:, -1])
            cache["index"].fill_(x.shape[1])
    if cache is not None and mode != "train":
        cache["conv"].copy_(new_conv)
    else:
        cache = None
    return (y_branch * h.to(x.dtype)) @ params["w_o"], cache
