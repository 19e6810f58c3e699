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

Tensor parallel (``tp``, a ``shardctx.LayerTP``): a rank
owns a contiguous block of the ``inner`` channels — its ``w_y``/``w_x``
columns, ``conv``, ``b_*``, ``lam``, its cache's ``state`` and ``conv``
blocks, its ``w_o`` rows (row-parallel) — on every row (the residual's
rows all-gathered in under a split).  The block-diagonal gates ``w_a``/
``w_i`` (nb, bs, bs), whose spec splits every block's columns, are held
as the gate columns of the rank's channels, the same bytes
(``pdefs.gate_blocks``): where ``model`` divides nb the rank's channels
are whole blocks and need nothing from another rank; where nb divides
``model`` the m / nb ranks that share a block all-gather their conv
outputs, the block's inputs, over their subgroup.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import comm
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
                         axes=(None, None, "inner"), layout="block_diag"),
        "w_i": ParamSpec((nb, bs, bs), "lecun", bs,
                         axes=(None, None, "inner"), layout="block_diag"),
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


def _block_diag(x, w, b, xin=None):
    """x: (..., c); w: (nb, bs, cols) blocks over the nb·bs channels of
    ``xin`` (``x`` itself unless given) -> (..., c), in x's dtype."""
    nb, bs, _ = w.shape
    src = x if xin is None else xin
    xs = src.reshape(*src.shape[:-1], nb, bs)
    y = torch.einsum("...nk,nkj->...nj", xs, w)
    return y.reshape(x.shape) + b


def _rglru_gates(params, u, xin=None):
    """u: (B, S, c) conv output -> (a, b_term), both float32.  ``xin``:
    the gate blocks' inputs where they are not ``u`` (a rank's gate
    columns of a block it shares, :func:`_gate_inputs`)."""
    r = torch.sigmoid(_block_diag(u, params["w_a"], params["b_a"],
                                  xin).float())
    i = torch.sigmoid(_block_diag(u, params["w_i"], params["b_i"],
                                  xin).float())
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


def _gate_inputs(u, tp):
    """The conv output a rank's gate columns read: ``u`` itself where its
    channels are whole gate blocks, else the shared block's channels
    all-gathered over the ranks that share it."""
    parts = tp.size
    if NUM_GATE_BLOCKS % parts == 0:
        return u
    from repro_torch.launch.mesh import model_subgroup

    share = parts // NUM_GATE_BLOCKS
    # each rank's gate columns read the block: partial gradients
    return comm.gather_partial(u, model_subgroup(tp.params.mesh, share), -1)


def rglru_apply(params, cfg: ArchConfig, x, *, mode: str = "train",
                cache: Optional[dict] = None, tp=None):
    """Griffin recurrent block.  x: (B, S, d) -> (y, cache).  Prefill and
    decode write ``cache`` in place and return it.  ``tp``: the layer's
    ``shardctx.LayerTP`` (the module docstring)."""
    if tp is not None:
        x = tp.rows_in(x, "rec/w_o")
    y_branch = act_fn("gelu")(x @ params["w_y"])
    u = x @ params["w_x"]
    u, new_conv = _causal_conv(u, params["conv"],
                               cache["conv"] if cache is not None else None)
    a, b = _rglru_gates(params, u, _gate_inputs(u, tp)
                        if tp is not None and tp.sharded("rec/w_a") else None)

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
    out = (y_branch * h.to(x.dtype)) @ params["w_o"]
    return (out if tp is None else tp.rows_out("rec/w_o", out)), cache
