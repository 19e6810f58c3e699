"""Mixture-of-Experts layer, the local path: top-k routing with sort-based
capacity dispatch (the JAX package's ``repro.models.moe`` without its
expert-parallel ``shard_map`` branch, which comes with the placement
slice).

Slots (token, k) are sorted by expert (a stable sort) and the first
``capacity`` of each expert are copied into an (E, C, d) buffer; the
experts run as batched matmuls; each kept slot's output, weighted, goes
back to its token.  A slot past its expert's capacity is dropped, so a
token's output depends on the other tokens of the call unless the
capacity holds every slot.  Experts are padded to a multiple of 16 (60 ->
64); the pad experts' router logits are -inf, so the function is the
unpadded model's.

Unlike the reference's scatter-add, the combine puts the slots back in
(token, k) order and sums over k: no atomics, the same bits on every call.
The capacity is computed on the host from shapes; nothing reads the
device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import act_fn, mlp, mlp_def
from repro_torch.models.pdefs import ParamSpec


def padded_experts(cfg: ArchConfig, axis: int = 16) -> int:
    return int(math.ceil(cfg.num_experts / axis) * axis)


def moe_capacity(cfg: ArchConfig, tokens: int, experts: int) -> int:
    """Slots an expert takes in a call over ``tokens`` tokens (the
    reference's formula: the mean load times the capacity factor, rounded
    up to a multiple of 8, at least 8)."""
    c = int(math.ceil(tokens * cfg.moe_top_k / experts
                      * cfg.moe_capacity_factor / 8) * 8)
    return max(c, 8)


def moe_def(cfg: ArchConfig):
    d, ff = cfg.d_model, cfg.moe_d_ff
    ep = padded_experts(cfg)
    defs = {
        "router": ParamSpec((d, ep), "lecun", d, dtype=torch.float32),
        "we_gate": ParamSpec((ep, d, ff), "lecun", d),
        "we_up": ParamSpec((ep, d, ff), "lecun", d),
        "we_down": ParamSpec((ep, ff, d), "lecun", ff),
    }
    if cfg.num_shared_experts:
        # shared experts fused into one wider always-on MLP
        defs["shared"] = mlp_def(d, ff * cfg.num_shared_experts)
    return defs


def router_probs(params, cfg: ArchConfig, x):
    """x: (T, d) -> (weights (T, K) float32, ids (T, K) int64, aux loss).
    Top-k in descending probability (``sorted=True``), the weights
    renormalised; aux is the Switch load-balancing loss E * sum_e f_e p_e."""
    router = params["router"]
    ep = router.shape[1]
    logits = x.float() @ router                              # (T, EP)
    if ep > cfg.num_experts:                                 # mask pad experts
        pad = torch.arange(ep, device=x.device) >= cfg.num_experts
        logits = logits.masked_fill(pad, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.moe_top_k, dim=-1, sorted=True)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    flat = ids.reshape(-1)
    counts = torch.zeros(ep, dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device))
    aux = cfg.num_experts * torch.sum(counts / flat.numel()
                                      * probs.mean(dim=0))
    return weights, ids, aux


def moe_apply(params, cfg: ArchConfig, x, capacity: Optional[int] = None):
    """x: (B, S, d) -> (y, aux loss), on one device (the reference's
    ``_moe_local``).  ``capacity`` (slots an expert takes) defaults to
    :func:`moe_capacity` of the call's tokens."""
    b, s, d = x.shape
    t = b * s
    k = cfg.moe_top_k
    xt = x.reshape(t, d)
    weights, ids, aux = router_probs(params, cfg, xt)
    ep = params["we_gate"].shape[0]
    if capacity is None:
        capacity = moe_capacity(cfg, t, ep)

    # slots sorted by expert (stable: by token within an expert); a slot's
    # rank in its expert from where the expert's run starts
    flat_ids = ids.reshape(-1)                               # (T*K,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(ep, device=x.device))
    rank = torch.arange(t * k, device=x.device) - starts[sorted_ids]
    keep = rank < capacity
    # a dropped slot goes to the extra last row, which is cut off
    dest = torch.where(keep, sorted_ids * capacity + rank, ep * capacity)
    buf = x.new_zeros((ep * capacity + 1, d)).index_copy(
        0, dest, xt[order // k])
    buf = buf[:ep * capacity].view(ep, capacity, d)

    g = act_fn(cfg.act)(torch.bmm(buf, params["we_gate"]))
    u = torch.bmm(buf, params["we_up"])
    yb = torch.bmm(g * u, params["we_down"]).reshape(ep * capacity, d)

    # back to (token, k) order: slot order[i] sits at sorted position i
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=x.device))
    dest_tk, keep_tk = dest[pos], keep[pos]
    y_slot = torch.where(keep_tk[:, None],
                         yb[dest_tk.clamp(max=ep * capacity - 1)], 0.0)
    out = (y_slot.float() * weights.reshape(-1)[:, None]).view(
        t, k, d).sum(dim=1)
    if cfg.num_shared_experts:
        out = out + mlp(params["shared"], xt, cfg.act).float()
    return out.to(x.dtype).reshape(b, s, d), aux
