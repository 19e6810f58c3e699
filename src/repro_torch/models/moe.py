"""Mixture-of-Experts layer: top-k routing with sort-based capacity
dispatch (the JAX package's ``repro.models.moe``), on one device or
expert-parallel over a mesh's ``model`` axis.

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

Expert parallelism (:func:`_moe_shard_map`, the reference's shard_map
branch): under an ambient mesh with a ``model`` axis of more than one rank
whose size divides the padded expert count, each rank holds its data
shard's tokens and routes them to the ``ep / model`` experts it owns,
dropping past a per-rank capacity ``c_loc``; one all-reduce over the
``model`` group (the reference's ``psum``) sums the partial outputs, and
the aux loss is averaged over the data axes.
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
        "router": ParamSpec((d, ep), "lecun", d, dtype=torch.float32,
                            axes=("embed", None)),
        "we_gate": ParamSpec((ep, d, ff), "lecun", d,
                             axes=("expert", "embed", None)),
        "we_up": ParamSpec((ep, d, ff), "lecun", d,
                           axes=("expert", "embed", None)),
        "we_down": ParamSpec((ep, ff, d), "lecun", ff,
                             axes=("expert", None, "embed")),
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
    """x: (B, S, d) -> (y, aux loss).  Expert-parallel
    (:func:`_moe_shard_map`) under an ambient mesh whose ``model`` axis has
    more than one rank and divides the padded expert count (on a mesh,
    ``x`` is this rank's data shard of the tokens); else the local path."""
    from repro_torch.models.shardctx import current_mesh

    mesh = current_mesh()
    if mesh is not None:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
        msize = sizes.get("model", 1)
        if msize > 1 and params["we_gate"].shape[0] % msize == 0:
            return _moe_shard_map(params, cfg, x, mesh, dp_axes, msize)
    return _moe_local(params, cfg, x, capacity)


def _dispatch(xt, ids, weights, wg, wu, wd, act, n_exp: int,
              capacity: int, lo: int = 0):
    """The sort-based dispatch over the experts [lo, lo + n_exp) of ``wg``,
    ``wu``, ``wd`` (their first dims); a slot routed elsewhere, or past its
    expert's ``capacity``, is dropped.  Returns the (T, d) float32 sum over
    each token's kept slots of weight x expert output."""
    t, d = xt.shape
    k = ids.shape[-1]
    dev = xt.device
    flat_ids = ids.reshape(-1)                               # (T*K,)
    mine = (flat_ids >= lo) & (flat_ids < lo + n_exp)
    loc_ids = torch.where(mine, flat_ids - lo, n_exp)        # n_exp: dropped
    # slots sorted by expert (stable: by token within an expert); a slot's
    # rank in its expert from where the expert's run starts
    order = torch.argsort(loc_ids, stable=True)
    sorted_ids = loc_ids[order]
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(n_exp + 1, device=dev))
    rank = torch.arange(t * k, device=dev) - starts[sorted_ids]
    keep = (sorted_ids < n_exp) & (rank < capacity)
    # a dropped slot goes to the extra last row, which is cut off
    dest = torch.where(keep, sorted_ids * capacity + rank, n_exp * capacity)
    buf = xt.new_zeros((n_exp * capacity + 1, d)).index_copy(
        0, dest, xt[order // k])
    buf = buf[:n_exp * capacity].view(n_exp, capacity, d)

    g = act(torch.bmm(buf, wg))
    u = torch.bmm(buf, wu)
    yb = torch.bmm(g * u, wd).reshape(n_exp * capacity, d)

    # back to (token, k) order: slot order[i] sits at sorted position i
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=dev))
    dest_tk, keep_tk = dest[pos], keep[pos]
    y_slot = torch.where(keep_tk[:, None],
                         yb[dest_tk.clamp(max=n_exp * capacity - 1)], 0.0)
    return (y_slot.float() * weights.reshape(-1)[:, None]).view(
        t, k, d).sum(dim=1)


def _moe_shard_map(params, cfg: ArchConfig, x, mesh, dp_axes, msize: int):
    """Expert-parallel MoE on this rank: its ``ep / msize`` experts over
    its tokens ``x`` (B, S, d), the partial outputs summed over the
    ``model`` group (one all-reduce), the aux loss averaged over the data
    axes.  Matches the local path within float32 rounding when no slot is
    dropped (the sums over a token's experts are taken in another order)."""
    from repro_torch import comm
    from repro_torch.launch.mesh import axes_group

    b, s, d = x.shape
    t = b * s
    ep = params["we_gate"].shape[0]
    e_loc = ep // msize
    c_loc = moe_capacity(cfg, t, ep)
    xt = x.reshape(t, d)
    weights, ids, aux = router_probs(params, cfg, xt)
    if dp_axes:
        group = axes_group(mesh, dp_axes)
        aux = comm.all_reduce_sum(aux, group) / comm.group_size(group)
    lo = mesh.get_local_rank("model") * e_loc
    part = slice(lo, lo + e_loc)
    out = _dispatch(xt, ids, weights, params["we_gate"][part],
                    params["we_up"][part], params["we_down"][part],
                    act_fn(cfg.act), e_loc, c_loc, lo)
    # the one collective: the experts' partials summed over `model`
    out = comm.all_reduce_sum(out, mesh.get_group("model"))
    if cfg.num_shared_experts:
        out = out + mlp(params["shared"], xt, cfg.act).float()
    return out.to(x.dtype).reshape(b, s, d), aux


def _moe_local(params, cfg: ArchConfig, x, capacity: Optional[int] = None):
    """x: (B, S, d) -> (y, aux loss) on one device.  ``capacity`` (slots
    an expert takes) defaults to :func:`moe_capacity` of the call's
    tokens."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    weights, ids, aux = router_probs(params, cfg, xt)
    ep = params["we_gate"].shape[0]
    if capacity is None:
        capacity = moe_capacity(cfg, t, ep)

    out = _dispatch(xt, ids, weights, params["we_gate"], params["we_up"],
                    params["we_down"], act_fn(cfg.act), ep, capacity)
    if cfg.num_shared_experts:
        out = out + mlp(params["shared"], xt, cfg.act).float()
    return out.to(x.dtype).reshape(b, s, d), aux
