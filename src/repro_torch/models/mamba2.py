"""Mamba2 block (SSD, state-space duality; Dao & Gu 2024), attention-free:
the JAX package's ``repro.models.mamba2``.

Train and prefill run the chunked SSD algorithm: the intra-chunk part as
decay-masked (chunk x chunk) products, per-chunk states, and the
recurrence over chunk states.  The reference scans the chunk states with
``jax.lax.associative_scan``; here the same recurrence is one product
with the chunks' cumulative decays (``exp`` of differences of their
summed log decays), a few launches instead of a loop over chunks.  Decode
is the O(1) state update.  The SSD math is float32, as the reference's.

Prefill and decode write the cache (state, conv carries, device int32
``index``) in place and return it, as the port's attention cache does: a
decode step reads nothing back to the host.

Tensor parallel (``tp``, a ``shardctx.LayerTP``): a rank
runs its ``inner`` channels and SSD heads (``in_x``/``in_z``/``in_dt``
columns, ``conv_x``, ``A_log``/``dt_bias``/``D``) on every row (the
residual's rows all-gathered in under a split), ``in_B``/``in_C`` and
their convolutions whole, as their specs are; the gated norm over the
split channels all-reduces its sum of squares, and ``out`` is
row-parallel.  The cache's ``conv_B``/``conv_C`` carries are split over
``model`` by the reference's ``_cache_spec_for`` although every rank
needs them whole: each call all-gathers the rank's blocks (one
all-gather of both) and writes its block of the new carry back.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import comm
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_def
from repro_torch.models.pdefs import ParamSpec


def mamba_def(cfg: ArchConfig):
    d, din = cfg.d_model, cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    h, w = cfg.ssm_nheads, cfg.ssm_conv_width
    f32 = torch.float32
    return {
        "in_x": ParamSpec((d, din), "lecun", d, axes=("embed", "inner")),
        "in_z": ParamSpec((d, din), "lecun", d, axes=("embed", "inner")),
        "in_B": ParamSpec((d, gn), "lecun", d, axes=("embed", None)),
        "in_C": ParamSpec((d, gn), "lecun", d, axes=("embed", None)),
        "in_dt": ParamSpec((d, h), "lecun", d, axes=("embed", "ssm_heads")),
        "conv_x": ParamSpec((w, din), "lecun", w, axes=("conv", "inner")),
        "conv_B": ParamSpec((w, gn), "lecun", w, axes=("conv", None)),
        "conv_C": ParamSpec((w, gn), "lecun", w, axes=("conv", None)),
        "A_log": ParamSpec((h,), "zeros", dtype=f32, axes=("ssm_heads",)),
        "dt_bias": ParamSpec((h,), "zeros", dtype=f32,
                             axes=("ssm_heads",)),
        "D": ParamSpec((h,), "ones", dtype=f32, axes=("ssm_heads",)),
        "norm": rmsnorm_def(din),
        "out": ParamSpec((din, d), "lecun", din, axes=("inner", "embed")),
    }


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device):
    gn = cfg.ssm_ngroups * cfg.ssm_state
    w = cfg.ssm_conv_width
    return {
        "state": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((batch, w - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, w - 1, gn), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w - 1, gn), dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def _causal_conv(x, kernel, carry=None):
    """Depthwise causal conv.  x: (B, S, C); kernel: (W, C); carry: (B,
    W-1, C), the previous inputs (decode, continuation) or None (zeros).
    Returns (out, new carry: the last W-1 inputs)."""
    w, s = kernel.shape[0], x.shape[1]
    if carry is None:
        carry = x.new_zeros((x.shape[0], w - 1, x.shape[2]))
    dt = torch.promote_types(carry.dtype, x.dtype)
    xp = torch.cat([carry.to(dt), x.to(dt)], dim=1)      # (B, S+W-1, C)
    out = xp[:, :s] * kernel[0]
    for i in range(1, w):
        out = out + xp[:, i:i + s] * kernel[i]
    return out, (xp[:, -(w - 1):] if w > 1 else carry)


def _ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD scan.  x: (b, s, h, p); dt: (b, s, h) (post-softplus);
    A: (h,) negative; B, C: (b, s, g, n); init_state: (b, h, p, n) or
    None.  Returns (y (b, s, h, p), final state (b, h, p, n)), float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg, q = h // g, chunk           # heads per group; head h in group h // hg
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of chunk {q}")
    nc = s // q
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    Br = B.reshape(b, nc, q, g, n)
    Cr = C.reshape(b, nc, q, g, n)

    cum = torch.cumsum(dtr * A, dim=2)      # (b,nc,q,h) inclusive log decay
    seg_total = cum[:, :, -1]               # (b,nc,h) a chunk's log decay
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()

    # intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j;
    # the masked exponent is -inf (exp(0) in no gradient)
    cb = torch.einsum("bcign,bcjgn->bcgij", Cr, Br)        # (b,nc,g,q,q)
    cum_h = cum.movedim(2, 3)                               # (b,nc,h,q)
    dec = cum_h[..., :, None] - cum_h[..., None, :]         # (b,nc,h,q,q)
    L = torch.exp(torch.where(causal, dec, float("-inf")))
    w_ij = (cb[:, :, :, None] * L.reshape(b, nc, g, hg, q, q)).reshape(
        b, nc, h, q, q)
    xdt = xr * dtr[..., None]                               # (b,nc,q,h,p)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", w_ij, xdt)

    # per-chunk states: S_c = sum_j exp(seg_total - cum_j) dt_j x_j (x) B_j
    wj = torch.exp(seg_total[:, :, None, :] - cum)          # (b,nc,q,h)
    S_c = torch.einsum("bcjgkp,bcjgn->bcgkpn",
                       (xdt * wj[..., None]).view(b, nc, q, g, hg, p),
                       Br).reshape(b, nc, h, p, n)

    # the recurrence over chunks, H_c = exp(seg_total_c) H_{c-1} + S_c, in
    # closed form: H_c = sum_{d<=c} exp(segcum_c - segcum_d) S_d +
    # exp(segcum_c) H_init
    S0 = init_state.float() if init_state is not None else \
        x.new_zeros((b, h, p, n))
    segcum = torch.cumsum(seg_total, dim=1)                 # (b,nc,h)
    dc = segcum.movedim(1, 2)                               # (b,h,nc)
    chunks_causal = torch.ones(nc, nc, dtype=torch.bool,
                               device=x.device).tril()
    decay = torch.exp(torch.where(chunks_causal,
                                  dc[..., :, None] - dc[..., None, :],
                                  float("-inf")))           # (b,h,nc,nc)
    H_incl = torch.einsum("bhcd,bdhpn->bchpn", decay, S_c) \
        + torch.exp(segcum)[..., None, None] * S0[:, None]
    H_in = torch.cat([S0[:, None], H_incl[:, :-1]], dim=1)  # each chunk's
                                                            # incoming state
    # inter-chunk: y_i += exp(cum_i) C_i . H_in
    y_inter = torch.einsum("bcign,bcgkpn->bcigkp", Cr,
                           H_in.view(b, nc, g, hg, p, n)).reshape(
        b, nc, q, h, p) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, H_incl[:, -1]


def _ssd_decode(x, dt, A, B, C, state):
    """One-token SSD update.  x: (b, h, p); dt: (b, h); B, C: (b, g, n);
    state: (b, h, p, n) -> (y (b, h, p), new state), float32."""
    x, dt, B, C, state = (t.float() for t in (x, dt, B, C, state))
    hg = x.shape[1] // B.shape[1]
    a = torch.exp(dt * A)                                   # (b,h)
    Bh = B.repeat_interleave(hg, dim=1)                     # (b,h,n)
    Ch = C.repeat_interleave(hg, dim=1)
    new_state = state * a[..., None, None] \
        + (x * dt[..., None])[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    return y, new_state


def _bc_carries(cache: dict, tp):
    """(conv_B, conv_C) carries whole: the rank's blocks all-gathered over
    ``model`` in one call where the cache splits them."""
    cb, cc = cache["conv_B"], cache["conv_C"]
    parts = tp.cache_split("conv_B", 2)[0]
    if parts == 1:
        return cb, cc
    both = comm.all_gather_cat(torch.stack([cb, cc]), tp.group, -1)
    return both[0], both[1]


def _bc_block(x, cache: dict, name: str, tp):
    """This rank's block of a whole ``conv_B``/``conv_C`` carry."""
    parts, index = tp.cache_split(name, 2)
    n = x.shape[-1] // parts
    return x.narrow(-1, index * n, n)


def mamba_apply(params, cfg: ArchConfig, x, *, mode: str = "train",
                cache: Optional[dict] = None, tp=None):
    """x: (B, S, d) -> (y, cache).  Modes: train | prefill | decode;
    prefill and decode write ``cache`` in place and return it.  ``tp``:
    the layer's ``shardctx.LayerTP`` (the module docstring)."""
    if tp is not None:
        x = tp.rows_in(x, "mamba/in_x")
    b, s, _ = x.shape
    h, p = cfg.ssm_nheads, cfg.ssm_head_dim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    if tp is not None and tp.sharded("mamba/in_x"):
        h = params["in_dt"].shape[-1]
        if h * p != params["in_x"].shape[-1] or g != 1:
            raise ValueError(f"{cfg.name}: SSD heads and inner channels "
                             f"must split together over one group")

    z = x @ params["in_z"]
    u = x @ params["in_x"]
    Bx = x @ params["in_B"]
    Cx = x @ params["in_C"]
    dt_raw = x @ params["in_dt"]

    carry = (lambda k: cache[k]) if cache is not None else (lambda k: None)
    cB, cC = carry("conv_B"), carry("conv_C")
    if tp is not None and cache is not None:
        cB, cC = _bc_carries(cache, tp)
    u, ncx = _causal_conv(u, params["conv_x"], carry("conv_x"))
    Bx, ncB = _causal_conv(Bx, params["conv_B"], cB)
    Cx, ncC = _causal_conv(Cx, params["conv_C"], cC)
    u, Bx, Cx = F.silu(u), F.silu(Bx), F.silu(Cx)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    ur = u.reshape(b, s, h, p)
    Br = Bx.reshape(b, s, g, n)
    Cr = Cx.reshape(b, s, g, n)

    if mode == "decode":
        if s != 1 or cache is None:
            raise ValueError("decode takes one token and a cache")
        y1, new_state = _ssd_decode(ur[:, 0], dt[:, 0], A, Br[:, 0],
                                    Cr[:, 0], cache["state"])
        y = y1[:, None]
        cache["state"].copy_(new_state)
        cache["index"].add_(1)
    else:
        chunk = min(cfg.ssm_chunk, s)
        # pad to a chunk multiple; a padded step has dt = 0 (decay exp(0)
        # = 1, no input), so the state passes through it unchanged
        pad = (-s) % chunk
        ur_p, dt_p, Br_p, Cr_p = (
            F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
            for t in (ur, dt, Br, Cr))
        init_state = cache["state"] if cache is not None else None
        y, final_state = _ssd_chunked(ur_p, dt_p, A, Br_p, Cr_p, chunk,
                                      init_state)
        y = y[:, :s]
        if mode == "prefill" and cache is not None:
            cache["state"].copy_(final_state)
            cache["index"].fill_(s)
    if cache is not None and mode != "train":
        if tp is not None:
            ncB, ncC = (_bc_block(c, cache, k, tp)
                        for c, k in ((ncB, "conv_B"), (ncC, "conv_C")))
        cache["conv_x"].copy_(ncx)
        cache["conv_B"].copy_(ncB)
        cache["conv_C"].copy_(ncC)
    else:
        cache = None

    y = y + ur.float() * params["D"][None, None, :, None]
    y = y.reshape(b, s, h * p).to(x.dtype)
    if tp is None or not tp.sharded("mamba/in_x"):
        y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
        out = y @ params["out"]
        return (out if tp is None else tp.rows_out("mamba/out", out)), cache
    # the gated norm over channels split over model: the rank's block of
    # its (replicated) scale, the sum of squares all-reduced
    width = params["norm"]["scale"].shape[0]
    c = y.shape[-1]
    scale = params["norm"]["scale"].narrow(0, tp.rank * c, c)
    y = rmsnorm({"scale": scale}, y * F.silu(z), cfg.norm_eps,
                group=tp.group, width=width)
    return tp.rows_out("mamba/out", y @ params["out"]), cache
