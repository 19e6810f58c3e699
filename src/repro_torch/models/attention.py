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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

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
              mode: str = "train"):
    """Returns (out, cache).  Modes: train | prefill | decode.  Prefill
    and decode write ``cache`` in place and return it."""
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
    if cfg.kv_quant:
        kq, ks = _quantize_kv(kk)
        vq, vs = _quantize_kv(vv)
        cache["k"].index_copy_(1, slots, kq)
        cache["v"].index_copy_(1, slots, vq)
        cache["k_scale"].index_copy_(1, slots, ks)
        cache["v_scale"].index_copy_(1, slots, vs)
    else:
        cache["k"].index_copy_(1, slots, kk.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slots, vv.to(cache["v"].dtype))
    cache["index"].fill_(s)
    return out, cache


def _attention_decode(params, cfg: ArchConfig, x, positions, *, window: int,
                      cache: dict):
    """One-token decode against the cache.  x: (B, 1, d)."""
    q, k, v = _project_qkv(params, cfg, x, positions)  # (B,1,H,D), (B,1,KV,D)
    cap = cache["k"].shape[1]
    idx = cache["index"]            # absolute position of the new token
    slot = idx % cap
    at = slot.long().view(1)
    if cfg.kv_quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k"].index_copy_(1, at, kq)
        cache["v"].index_copy_(1, at, vq)
        cache["k_scale"].index_copy_(1, at, ks)
        cache["v_scale"].index_copy_(1, at, vs)
        ck = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
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
