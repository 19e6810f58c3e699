"""Attention: GQA with RoPE / M-RoPE / qk-norm, causal + sliding-window
masks, and KV caches (a ring buffer for SWA, so long-context decode is
O(window) memory) — the JAX package's ``repro.models.attention``.

Heads stay flat (B, S, H, D) and KV heads are repeated to H at use, as in
the reference.  The attention is plain matmul math, as the reference's
einsums are: no model of the reference calls the flash kernels.

Cache layout (dict):
  k, v   : (B, C, KV, D) with C = cache capacity (= window for SWA, =
           max_seq for full attention).  RoPE is applied before writing.
  k_scale, v_scale : (B, C, KV) float32 per-(token, head) scales when the
           cache is int8 (``kv_quant``).
  index  : () int32 on the device — the number of tokens written so far.

Unlike the reference, prefill and decode write the cache IN PLACE (with
``index_copy_``) and return it: the slot, positions and ring mask are
computed on the device, so a decode step reads nothing back to the host.

Long sequences (S > BLOCKED_ATTN_THRESHOLD) use the blocked online-softmax
path (exact flash-style math, O(S * kv_block) live memory).

Tensor parallel (``tp``, a ``shardctx.LayerTP``): under the
``heads`` strategy a rank computes its q heads (``wq``'s block) against
the KV heads they read (``wk``/``wv``'s block, or the whole leaves where
``kv_heads`` does not divide ``model``, as the reference's GSPMD does) and
its ``wo`` rows' partial, summed over ``model`` (reduce-scattered over
the rows for ``seq_parallel``); under ``hidden`` (context parallel) the
weights are whole, a rank's query rows attend to every key (k and v
all-gathered over the rows), the masks taken at global positions.  The
cache is the rank's block of the reference's ``_cache_spec_for``: its KV
heads, or — where they do not divide — a contiguous range of slots of
every head.  Decode on a cache split over slots is a split-KV attention
across ranks: each rank's max, sum and context over its valid slots, the
max all-reduced, then the sums and contexts in one all-reduce (the
collective form of ``flash_decode``'s combine); the q heads a rank holds
are all-gathered first (every head reads every rank's slots), and only
the rank that owns slot ``index % cap`` writes the new token.  In train
mode the same code runs under grad: the heads form's input all-reduces
its partial gradients (reduce-scatters them under ``seq_parallel``) and
its whole leaves (``q_norm``/``k_norm``, and KV leaves that do not split)
get partial gradients; under a context-parallel split every leaf does
(each rank's rows), and the gathered keys' backward reduce-scatters
(``backbone.partial_leaves`` names these leaves for the gradient sync).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import comm
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (apply_m_rope, apply_rope, rmsnorm,
                                       rmsnorm_def)
from repro_torch.models.pdefs import ParamSpec

NEG_INF = -1e30
BLOCKED_ATTN_THRESHOLD = 2048
KV_BLOCK = 1024


def attention_def(cfg: ArchConfig):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # logical axes: heads shard over `model` under the heads TP strategy
    hx = "heads" if cfg.tp_strategy == "heads" else None
    kx = "kv_heads" if cfg.tp_strategy == "heads" else None
    defs = {
        "wq": ParamSpec((d, H, hd), "lecun", d, axes=("embed", hx, None)),
        "wk": ParamSpec((d, KV, hd), "lecun", d, axes=("embed", kx, None)),
        "wv": ParamSpec((d, KV, hd), "lecun", d, axes=("embed", kx, None)),
        "wo": ParamSpec((H, hd, d), "lecun", H * hd,
                        axes=(hx, None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamSpec((H, hd), "zeros", axes=(hx, None))
        defs["bk"] = ParamSpec((KV, hd), "zeros", axes=(kx, None))
        defs["bv"] = ParamSpec((KV, hd), "zeros", axes=(kx, None))
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_def(hd)
        defs["k_norm"] = rmsnorm_def(hd)
    return defs


def init_attn_cache(cfg: ArchConfig, batch: int, max_seq: int, window: int,
                    dtype, device):
    cap = min(window, max_seq) if window else max_seq
    kv_shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    index = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kv_quant:
        # int8 cache with per-(token, head) absmax scales
        return {"k": torch.zeros(kv_shape, dtype=torch.int8, device=device),
                "v": torch.zeros(kv_shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(kv_shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(kv_shape[:3], dtype=torch.float32,
                                       device=device),
                "index": index}
    return {"k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "v": torch.zeros(kv_shape, dtype=dtype, device=device),
            "index": index}


def _quantize_kv(x):
    """(..., D) -> int8 values + (...,) float32 absmax scales (round half
    to even, as ``jnp.round``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _heads(x, w):
    """x (B, S, d) @ w (d, H, D) -> (B, S, H, D): the reference's
    ``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(params, cfg: ArchConfig, x, positions):
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.m_rope:
        q = apply_m_rope(q, positions, cfg.rope_theta, cfg.m_rope_sections)
        k = apply_m_rope(k, positions, cfg.rope_theta, cfg.m_rope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(x, g: int):
    """(B, T, KV, D) -> (B, T, KV*g, D)."""
    if g == 1:
        return x
    b, t, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, t, kv, g, d).reshape(b, t, kv * g, d)


def _out(params, ctx, dtype):
    """ctx (B, S, H, D) -> (B, S, d): the reference's
    ``einsum("bshd,hdo->bso")`` at the activation dtype."""
    h, k, d = params["wo"].shape
    return ctx.to(dtype).reshape(*ctx.shape[:2], h * k) \
        @ params["wo"].reshape(h * k, d)


def _dense_attention(q, kf, vf, pos_q, pos_k, *, window: int, causal: bool):
    """q: (B,S,H,D); kf, vf: (B,T,H,D) (kv already repeated).  float32
    softmax."""
    d = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          kf.float()) / math.sqrt(d)
    qp = pos_q[:, :, None]
    kp = pos_k[:, None, :]
    mask = torch.ones(qp.shape[0], qp.shape[1], kp.shape[2], dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf.float())


def _blocked_attention(q, kf, vf, pos_q, pos_k, *, window: int, causal: bool,
                       kv_block: int):
    """Flash-style exact attention: online softmax over KV blocks, O(S *
    kv_block) live memory.  q: (B,S,H,D); kf, vf: (B,T,H,D).

    The reference's dtypes: QK^T of activation-dtype values with float32
    sums, P cast to the value dtype for P.V with float32 sums.  Torch has
    no bf16 x bf16 -> float32 product on every device, so the operands are
    widened to float32 (exactly) and multiplied there.  The last block is
    not padded: the reference's padded keys weigh exactly 0."""
    d = q.shape[-1]
    t = kf.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2)                            # (B,H,S,D)
    b, h, s, _ = qf.shape
    acc = torch.zeros(b, h, s, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, s, dtype=torch.float32, device=q.device)
    for start in range(0, t, kv_block):
        kb = kf[:, start:start + kv_block]
        vb = vf[:, start:start + kv_block]
        pk = pos_k[:, start:start + kv_block]
        sc = (qf @ kb.float().permute(0, 2, 3, 1)) * scale    # (B,H,S,Tb)
        mask = torch.ones(b, s, kb.shape[1], dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= pk[:, None, :] <= pos_q[:, :, None]
        if window:
            mask &= pk[:, None, :] > pos_q[:, :, None] - window
        sc = torch.where(mask[:, None, :, :], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(vb.dtype).float() \
            @ vb.float().transpose(1, 2)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]          # (B,H,S,D)
    return out.transpose(1, 2)                                 # (B,S,H,D)


def attention(params, cfg: ArchConfig, x, positions, *, window: int,
              causal: bool = True, cache: Optional[dict] = None,
              mode: str = "train", tp=None):
    """Returns (out, cache).  Modes: train | prefill | decode.  Prefill
    and decode write ``cache`` in place and return it.  ``tp``: the
    layer's ``shardctx.LayerTP`` (the module docstring)."""
    if tp is not None:
        if mode == "decode":
            return _decode_tp(params, cfg, x, positions, window=window,
                              cache=cache, tp=tp)
        return _attention_tp(params, cfg, x, positions, window=window,
                             causal=causal, cache=cache, mode=mode, tp=tp)
    if mode == "decode":
        return _attention_decode(params, cfg, x, positions, window=window,
                                 cache=cache)

    q, k, v = _project_qkv(params, cfg, x, positions)
    g = cfg.num_heads // cfg.num_kv_heads
    kf, vf = _repeat_kv(k, g), _repeat_kv(v, g)
    s = x.shape[1]
    pos_q = positions[0] if cfg.m_rope else positions  # temporal stream
    if s > BLOCKED_ATTN_THRESHOLD:
        ctx = _blocked_attention(q, kf, vf, pos_q, pos_q, window=window,
                                 causal=causal, kv_block=KV_BLOCK)
    else:
        ctx = _dense_attention(q, kf, vf, pos_q, pos_q, window=window,
                               causal=causal)
    out = _out(params, ctx, x.dtype)

    if mode != "prefill" or cache is None:
        return out, None
    cap = cache["k"].shape[1]
    # keep the last `cap` keys/values (ring layout: slot = pos % cap)
    kk, vv = k[:, -cap:], v[:, -cap:]
    n = kk.shape[1]
    slots = (torch.arange(n, device=x.device) + (s - n)) % cap
    _write(cfg, cache, slots, kk, vv)
    cache["index"].fill_(s)
    return out, cache


def _entries_of(cfg: ArchConfig, cache: dict, kk, vv) -> dict:
    """The cache leaves' new values for keys/values ``kk``, ``vv``: int8
    values and their scales, or the values in the cache's dtype."""
    if cfg.kv_quant:
        kq, ks = _quantize_kv(kk)
        vq, vs = _quantize_kv(vv)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": kk.to(cache["k"].dtype), "v": vv.to(cache["v"].dtype)}


def _write(cfg: ArchConfig, cache: dict, slots, kk, vv) -> None:
    """Keys/values ``kk``, ``vv`` (B, n, KV, D) written in place at the
    cache's slots ``slots`` (n,)."""
    for name, new in _entries_of(cfg, cache, kk, vv).items():
        cache[name].index_copy_(1, slots, new)


def _write_where(cfg: ArchConfig, cache: dict, at, keep, kk, vv) -> None:
    """Writes ``kk``, ``vv`` at local slots ``at`` (n,) where ``keep`` (n,)
    holds and rewrites the old values elsewhere: a write decided on the
    device, with no host read."""
    for name, new in _entries_of(cfg, cache, kk, vv).items():
        old = cache[name].index_select(1, at)
        mask = keep.view((1, -1) + (1,) * (new.dim() - 2))
        cache[name].index_copy_(1, at, torch.where(mask, new, old))


def _attention_decode(params, cfg: ArchConfig, x, positions, *, window: int,
                      cache: dict):
    """One-token decode against the cache.  x: (B, 1, d)."""
    q, k, v = _project_qkv(params, cfg, x, positions)  # (B,1,H,D), (B,1,KV,D)
    cap = cache["k"].shape[1]
    idx = cache["index"]            # absolute position of the new token
    slot = idx % cap
    at = slot.long().view(1)
    _write(cfg, cache, at, k, v)
    if cfg.kv_quant:
        ck = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        ck, cv = cache["k"], cache["v"]

    # validity: absolute position of each slot given the ring layout
    slots = torch.arange(cap, device=x.device)
    wraps = idx // cap
    abs_pos = torch.where(slots <= slot, wraps * cap + slots,
                          (wraps - 1) * cap + slots)
    valid = (abs_pos >= 0) & (abs_pos <= idx)
    if window:
        valid &= abs_pos > idx - window

    g = cfg.num_heads // cfg.num_kv_heads
    kf, vf = _repeat_kv(ck, g), _repeat_kv(cv, g)
    d = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          kf.float()) / math.sqrt(d)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,bthd->bshd", probs, vf.float())
    out = _out(params, ctx, x.dtype)
    idx.add_(1)
    return out, cache


# ---------------------------------------------------------------------------
# Tensor parallel (the module docstring)
# ---------------------------------------------------------------------------


def _head_range(tp, name: str, n: int):
    """The [lo, hi) heads of leaf ``name``'s heads dim this rank holds."""
    if not tp.sharded(name):
        return 0, n
    per = n // tp.size
    return tp.rank * per, (tp.rank + 1) * per


def _kv_for(k, h0: int, h1: int, g: int, k0: int):
    """k (B, T, nk, D) holding KV heads [k0, k0 + nk) -> (B, T, h1 - h0, D):
    the KV head each q head of [h0, h1) reads (head h reads h // g)."""
    if h0 % g == 0 and h1 % g == 0:
        return _repeat_kv(k[:, :, h0 // g - k0:h1 // g - k0], g)
    idx = torch.arange(h0, h1, device=k.device) // g - k0
    return k.index_select(2, idx)


def _core(q, kf, vf, pos_q, pos_k, *, window: int, causal: bool, s: int):
    if s > BLOCKED_ATTN_THRESHOLD:
        return _blocked_attention(q, kf, vf, pos_q, pos_k, window=window,
                                  causal=causal, kv_block=KV_BLOCK)
    return _dense_attention(q, kf, vf, pos_q, pos_k, window=window,
                            causal=causal)


def _attention_tp(params, cfg: ArchConfig, x, positions, *, window: int,
                  causal: bool, cache, mode: str, tp):
    """Train / prefill on a rank's blocks; x is the residual's layout
    (this rank's rows under ``tp.seq_split``), ``positions`` every row's."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    g = H // KV
    pos = positions[0] if cfg.m_rope else positions          # (B, S)
    s = pos.shape[-1]
    if cfg.tp_strategy == "hidden":
        # context parallel: whole weights on this rank's rows, every key
        rows = x.shape[1]
        q, k, v = _project_qkv(params, cfg, x,
                               positions.narrow(-1, tp.row0, rows))
        if tp.seq_split:
            # each rank's queries read every key: partial gradients
            kv = comm.gather_partial(torch.cat([k, v], dim=-1), tp.group, 1)
            k, v = kv.chunk(2, dim=-1)
        ctx = _core(q, _repeat_kv(k, g), _repeat_kv(v, g),
                    pos.narrow(-1, tp.row0, rows), pos, window=window,
                    causal=causal, s=s)
        out, k0 = _out(params, ctx, x.dtype), 0
    else:
        q, k, v = _project_qkv(params, cfg, tp.rows_in(x, "attn/wq"),
                               positions)
        h0, h1 = _head_range(tp, "attn/wq", H)
        k0 = _head_range(tp, "attn/wk", KV)[0]
        ctx = _core(q, _kv_for(k, h0, h1, g, k0), _kv_for(v, h0, h1, g, k0),
                    pos, pos, window=window, causal=causal, s=s)
        out = tp.rows_out("attn/wo", _out(params, ctx, x.dtype))
    if mode != "prefill" or cache is None:
        return out, None
    # the heads and slots of the cache's block (``_cache_spec_for``)
    cap_loc, nk = cache["k"].shape[1], cache["k"].shape[2]
    c0 = tp.cache_split("k", 2)[1] * nk
    k, v = k[:, :, c0 - k0:c0 - k0 + nk], v[:, :, c0 - k0:c0 - k0 + nk]
    parts, index = tp.cache_split("k", 1)
    cap = cap_loc * parts
    if parts == 1:
        kk, vv = k[:, -cap:], v[:, -cap:]
        n = kk.shape[1]
        _write(cfg, cache, (torch.arange(n, device=x.device) + (s - n))
               % cap, kk, vv)
    else:
        # each local slot's position among the last min(s, cap) tokens
        n = min(s, cap)
        gslot = torch.arange(index * cap_loc, (index + 1) * cap_loc,
                             device=x.device)
        p = gslot + cap * torch.div(s - 1 - gslot, cap, rounding_mode="floor")
        at = torch.arange(cap_loc, device=x.device)
        src = p.clamp(0, s - 1)
        _write_where(cfg, cache, at, p >= s - n, k.index_select(1, src),
                     v.index_select(1, src))
    cache["index"].fill_(s)
    return out, cache


def _decode_tp(params, cfg: ArchConfig, x, positions, *, window: int,
               cache: dict, tp):
    """One-token decode on a rank's blocks and cache block; x (B, 1, d)
    whole over ``model``."""
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = H // KV
    q, k, v = _project_qkv(params, cfg, x, positions)
    h0, h1 = _head_range(tp, "attn/wq", H)
    k0 = _head_range(tp, "attn/wk", KV)[0]
    cap_loc, nk = cache["k"].shape[1], cache["k"].shape[2]
    c0 = tp.cache_split("k", 2)[1] * nk
    parts, index = tp.cache_split("k", 1)
    cap, s0 = cap_loc * parts, index * cap_loc
    idx = cache["index"]
    slot = idx % cap
    kn, vn = k[:, :, c0 - k0:c0 - k0 + nk], v[:, :, c0 - k0:c0 - k0 + nk]
    if parts == 1:
        _write(cfg, cache, slot.long().view(1), kn, vn)
    else:                           # only the owner of the slot writes
        local = slot - s0
        _write_where(cfg, cache, local.clamp(0, cap_loc - 1).long().view(1),
                     ((local >= 0) & (local < cap_loc)).view(1), kn, vn)
    if cfg.kv_quant:
        ck = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        ck, cv = cache["k"], cache["v"]
    slots = torch.arange(s0, s0 + cap_loc, device=x.device)
    wraps = idx // cap
    abs_pos = torch.where(slots <= slot, wraps * cap + slots,
                          (wraps - 1) * cap + slots)
    valid = (abs_pos >= 0) & (abs_pos <= idx)
    if window:
        valid &= abs_pos > idx - window

    if parts > 1 and (h0, h1) != (0, H):
        # every head reads every rank's slots
        q = comm.all_gather_cat(q, tp.group, 2)
        h0, h1 = 0, H
    a0, a1 = (c0 * g, (c0 + nk) * g) if nk < KV else (h0, h1)
    qa = q[:, :, a0 - h0:a1 - h0]
    kf, vf = _kv_for(ck, a0, a1, g, c0), _kv_for(cv, a0, a1, g, c0)
    scores = torch.einsum("bshd,bthd->bhst", qa.float(),
                          kf.float()) / math.sqrt(D)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    if parts == 1:
        ctx = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1),
                           vf.float())
    else:
        top = comm.all_reduce_max(scores.amax(dim=-1, keepdim=True),
                                  tp.group)
        p = torch.exp(scores - top)
        part = torch.einsum("bhst,bthd->bshd", p, vf.float())
        den = p.sum(dim=-1)                                   # (B, h, 1)
        packed = tp.sum(torch.cat([part.reshape(-1),
                                   den.reshape(-1)]))
        part = packed[:part.numel()].view(part.shape)
        den = packed[part.numel():].view(den.shape)
        ctx = part / den.permute(0, 2, 1)[..., None]
    if tp.sharded("attn/wo"):
        o0, o1 = _head_range(tp, "attn/wo", H)
        out = tp.sum(_out(params, ctx[:, :, o0 - a0:o1 - a0], x.dtype))
    else:
        wo = params["wo"][a0:a1]
        n = (a1 - a0) * D
        out = ctx.to(x.dtype).reshape(*ctx.shape[:2], n) \
            @ wo.reshape(n, wo.shape[-1])
        if (a0, a1) != (0, H):
            out = tp.sum(out)
    idx.add_(1)
    return out, cache
