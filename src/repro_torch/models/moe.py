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

Expert parallelism (``tp``, a ``shardctx.LayerTP`` over a rank's
blocks): the experts are the rank's block of ``we_*`` (``expert``
over ``model``, the reference's shard_map in_specs); each rank routes all
its data shard's tokens with the whole router and dispatches them to the
experts it owns, dropping past the capacity of the call's tokens; the
shared-expert MLP is column/row parallel over ``mlp``.  The experts'
partials and the shared MLP's are added first and summed over ``model``
in the layer's one all-reduce (the reference's ``psum``; a reduce-scatter
over the rows under a sequence split), and in ``train`` mode the aux loss
is averaged over the data axes.  Under grad the layer computes on each
rank's partial gradients: its input's backward all-reduces them, the
whole router's gradient is partial (``backbone.partial_leaves``), and
the aux loss — the same on every rank — hands each rank 1/model of its
gradient (as a whole shared MLP's output does beside split experts).
The LM backbones pass their layer's ``tp``; under an ambient mesh whose
``model`` axis has more than one rank and divides the padded expert
count, ``moe_apply`` builds it from a whole tree
(:func:`expert_parallel`, the reference's shard_map branch).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import comm
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


def moe_apply(params, cfg: ArchConfig, x, capacity: Optional[int] = None,
              tp=None, mode: str = "train"):
    """x: (B, S, d) -> (y, aux loss).  ``tp``: the layer's
    ``shardctx.LayerTP`` (the module docstring).  Without one, expert
    parallel (:func:`expert_parallel`) under an ambient mesh whose
    ``model`` axis has more than one rank and divides the padded expert
    count (on a mesh, ``x`` is this rank's data shard of the tokens); else
    the local path."""
    from repro_torch.models.shardctx import current_mesh

    if tp is not None:
        return _moe_tp(params, cfg, x, tp, mode)

    mesh = current_mesh()
    if mesh is not None:
        msize = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get("model",
                                                                     1)
        if msize > 1 and params["we_gate"].shape[0] % msize == 0:
            return expert_parallel(params, cfg, x, mesh, mode)
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


def expert_parallel(params, cfg: ArchConfig, x, mesh, mode: str = "train"):
    """The MoE layer of a whole tree ``params`` on this rank of ``mesh``:
    its blocks of :func:`moe_def` (its experts over ``model``, the embed
    rows gathered over the data axes) through the tensor-parallel form.
    Matches the local path within float32 rounding when no slot is
    dropped (the sums over a token's experts are taken in another order);
    at one model rank, bit for bit."""
    from repro_torch.models.shardctx import LayerTP, ShardedParams

    sp = ShardedParams.build({"moe": params}, {"moe": moe_def(cfg)}, mesh)
    return _moe_tp(sp.gather_tree("moe/", sp["moe"]), cfg, x, LayerTP(sp),
                   mode)


def _moe_tp(params, cfg: ArchConfig, x, tp, mode: str):
    """The MoE layer on a rank's blocks (the module docstring)."""
    xt_rows = tp.rows_in(x, "moe/we_gate")
    partial = tp.seq_split or tp.sharded("moe/we_gate")
    b, s, d = xt_rows.shape
    t = b * s
    xt = xt_rows.reshape(t, d)
    weights, ids, aux = router_probs(params, cfg, xt)
    group = tp.params.data_group()
    if mode == "train" and group is not None \
            and comm.group_size(group) > 1:
        aux = comm.sum_replicated(aux, group) / comm.group_size(group)
    if partial:
        aux = tp.share_grad(aux)
    e_loc = params["we_gate"].shape[0]
    ep = padded_experts(cfg)
    lo = tp.rank * e_loc if tp.sharded("moe/we_gate") else 0
    out = _dispatch(xt, ids, weights, params["we_gate"], params["we_up"],
                    params["we_down"], act_fn(cfg.act), e_loc,
                    moe_capacity(cfg, t, ep), lo)
    shared = cfg.num_shared_experts
    if shared and tp.sharded("moe/shared/wo") == tp.sharded("moe/we_gate"):
        out = out + mlp(params["shared"], xt, cfg.act).float()
        shared = 0
    out = tp.rows_out("moe/we_gate", out.view(b, s, d))
    if shared:
        y = tp.rows_out("moe/shared/wo", mlp(params["shared"], xt,
                                             cfg.act).view(b, s, d))
        if partial and not tp.seq_split:
            y = tp.share_grad(y)
        out = out + y.float()
    return out.to(x.dtype), aux


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
