"""DiT (Peebles & Xie 2023) — the paper's own denoiser — as plain functions
on a dict of tensors.

Class-conditional latent transformer with adaLN-zero conditioning.  The
VAE/patchify frontend is a stub: inputs are (B, N, latent_dim) latent
tokens, the space the paper's sampling experiments operate in.

Parameters keep the JAX package's layouts (``wq`` (d, H, hd), ``wo``
(H, hd, d), blocks stacked on a leading layer axis), so the JAX param tree
converts leaf for leaf (:mod:`repro_torch.diffusion.convert`).  The large
products stay ``torch.matmul``/``einsum``, as the JAX package leaves them
to XLA.

On a rank mesh ``dit_apply`` takes a rank's shards instead
(:class:`repro_torch.models.shardctx.ShardedParams`, from
``Placement.shard_params(params, dit_defs(cfg))``) and runs the Megatron
forward the JAX package's GSPMD derives from ``LOGICAL_RULES``: the adaLN
products give this rank's contiguous columns of the modulation, rebuilt by
one all-gather over ``model``; ``wq``/``wk``/``wv`` are column-parallel
over the rank's heads and ``wo`` row-parallel, its partial sums added by
one all-reduce over ``model`` (the MLP likewise); the ``embed`` rows of a
block's leaves are all-gathered over the data axes just before the block,
in one flat all-gather, and those of the top-level leaves in one at the
start of the call.  A call issues 2L all-reduces and L + 1 all-gathers
over ``model``, and L + 1 all-gathers over the data axes when they have
more than one rank (none at one).  At ``model`` = 1 the products are the
host path's on the same tensors, bit for bit.

Under grad the same forward differentiates as GSPMD's would: ``cond`` and
each block's modulated inputs enter the split heads and MLP through
``ShardedParams.model_in`` (their backward all-reduces the partial
gradients over ``model``), the adaLN columns' all-gather keeps the rank's
columns of the gradient and the partial sums' all-reduce passes it
through, and a block's data-axis gather reduce-scatters its gradient.
With ``remat`` each block — its gather included — runs again in the
backward pass.  :func:`dit_loss` on a mesh is the global batch's mean
(each rank's rows' mean, averaged over the data axes), and
:func:`tp_train_collectives` counts a train step's collectives.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import constant, to_device
from repro_torch.models.layers import (layernorm_noaffine, mlp,
                                       sincos_positions, sinusoidal_embed)
from repro_torch.models.pdefs import ParamSpec
from repro_torch.models.shardctx import ShardedParams, remat_tp

TEMB_DIM = 256


def dit_defs(cfg: ArchConfig) -> Dict:
    """The DiT's parameter tree (shapes + inits), blocks stacked on a
    leading layer axis — the shapes of the JAX package's ``dit_defs``."""
    d, ff, H, hd, L = (cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim,
                       cfg.num_layers)
    qkv = ("layers", "embed", "heads", None)
    block = {
        "ada": ParamSpec((L, d, 6 * d), "zeros",
                         axes=("layers", "embed", "cond")),
        "wq": ParamSpec((L, d, H, hd), "lecun", d, axes=qkv),
        "wk": ParamSpec((L, d, H, hd), "lecun", d, axes=qkv),
        "wv": ParamSpec((L, d, H, hd), "lecun", d, axes=qkv),
        "wo": ParamSpec((L, H, hd, d), "lecun", H * hd,
                        axes=("layers", "heads", None, "embed")),
        "mlp": {"wi_gate": ParamSpec((L, d, ff), "lecun", d,
                                     axes=("layers", "embed", "mlp")),
                "wi_up": ParamSpec((L, d, ff), "lecun", d,
                                   axes=("layers", "embed", "mlp")),
                "wo": ParamSpec((L, ff, d), "lecun", ff,
                                axes=("layers", "mlp", "embed"))},
    }
    return {
        "in_proj": ParamSpec((cfg.latent_dim, d), "lecun", cfg.latent_dim,
                             axes=(None, "embed")),
        "t_mlp1": ParamSpec((TEMB_DIM, d), "lecun", TEMB_DIM,
                            axes=(None, "embed")),
        "t_mlp2": ParamSpec((d, d), "lecun", d, axes=(None, "embed")),
        "y_embed": ParamSpec((cfg.num_classes + 1, d), "normal",
                             axes=(None, "embed")),
        "blocks": block,
        "final_ada": ParamSpec((d, 2 * d), "zeros", axes=("embed", "cond")),
        "out_proj": ParamSpec((d, cfg.latent_dim), "zeros",
                              axes=("embed", None)),
    }


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _dit_attention(p, x):
    """Full (non-causal) attention, scores and softmax in float32.
    x: (B, N, d); p["wq"|"wk"|"wv"] (d, H, hd); p["wo"] (H, hd, d) — on a
    model rank its H heads' blocks, and the result its partial sum."""
    b, n, d = x.shape
    _, H, hd = p["wq"].shape

    def heads(w):
        return (x @ w.reshape(d, H * hd)).reshape(b, n, H, hd)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    scores = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float())
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
    ctx = torch.einsum("bhnm,bmhk->bnhk", probs, v.float()).to(x.dtype)
    return ctx.reshape(b, n, H * hd) @ p["wo"].reshape(H * hd, d)


def _positions(n: int, d: int, dtype, device) -> torch.Tensor:
    """The (n, d) sincos position table on ``device``, made once per (n, d,
    dtype, device) from the same numpy values, so no call copies it from
    the host."""
    return constant(("dit_positions", n, d, dtype, torch.device(device)),
                    lambda: to_device(sincos_positions(n, d), dtype, device))


def dit_apply(params, cfg: ArchConfig, latents, t, y=None, *,
              remat: bool = False):
    """eps prediction.  latents: (B, N, latent_dim); t: (B,) float
    timesteps; y: (B,) int class labels (None -> the null class).
    ``params`` is the parameter tree, or a rank's :class:`ShardedParams`
    on a mesh (the tensor-parallel forward: module docstring).
    ``remat`` recomputes each block's activations in the backward pass
    instead of keeping them (the reference's ``jax.checkpoint(block)``)."""
    tp = params if isinstance(params, ShardedParams) else None
    tree = tp.local if tp is not None else params

    def full(blocks):
        return tp.gather(blocks) if tp is not None else blocks

    def cat(path, x):
        return tp.model_cat(path, x) if tp is not None else x

    def reduce(path, x):
        return tp.model_sum(path, x) if tp is not None else x

    def split_in(path, x):
        return tp.model_in(path, x) if tp is not None else x

    b, n, _ = latents.shape
    d = cfg.d_model
    top = full({k: tree[k] for k in ("in_proj", "t_mlp1", "t_mlp2",
                                     "y_embed", "final_ada", "out_proj")})
    x = latents @ top["in_proj"]
    x = x + _positions(n, d, x.dtype, x.device)[None]

    temb = sinusoidal_embed(t, TEMB_DIM).to(x.dtype)
    cond = F.silu(temb @ top["t_mlp1"]) @ top["t_mlp2"]
    if y is None:
        y = torch.full((b,), cfg.num_classes, dtype=torch.long,
                       device=x.device)                       # null class
    cond = F.silu(cond + top["y_embed"][y])
    # every block's adaLN product and the final one read cond through
    # their split columns: one all-reduce of its gradient for them all
    cond_ada = split_in("blocks/ada", cond)
    cond_final = cond_ada if tp is None or tp.sharded("final_ada") == \
        tp.sharded("blocks/ada") else split_in("final_ada", cond)

    def block(p, p_mlp, x):
        mod = cat("blocks/ada", cond_ada @ p["ada"])
        s1, sc1, g1, s2, sc2, g2 = mod.chunk(6, dim=-1)
        h = _dit_attention(p, split_in("blocks/wq", _modulate(
            layernorm_noaffine(x), s1, sc1)))
        x = x + g1[:, None, :] * reduce("blocks/wo", h)
        h = mlp(p_mlp, split_in("blocks/mlp/wo", _modulate(
            layernorm_noaffine(x), s2, sc2)), "gelu")
        return x + g2[:, None, :] * reduce("blocks/mlp/wo", h)

    def gathered_block(layer, layer_mlp, x):
        # a sharded block's embed rows gathered just before it (again in
        # the backward pass under remat)
        whole = full({**{f"blocks/{k}": v for k, v in layer.items()},
                      **{f"blocks/mlp/{k}": v
                         for k, v in layer_mlp.items()}})
        return block({k: whole[f"blocks/{k}"] for k in layer},
                     {k: whole[f"blocks/mlp/{k}"] for k in layer_mlp}, x)

    # each stacked (L, ...) leaf split into its layers once: the backward of
    # unbind stacks the layers' grads in one pass, where the backward of
    # indexing the stack per layer fills a zero copy of the whole stack for
    # every layer and sums the L copies (O(L^2) traffic)
    layers = {k: v.unbind(0) for k, v in tree["blocks"].items()
              if k != "mlp"}
    layers_mlp = {k: v.unbind(0) for k, v in tree["blocks"]["mlp"].items()}
    for i in range(cfg.num_layers):
        p = {k: v[i] for k, v in layers.items()}
        p_mlp = {k: v[i] for k, v in layers_mlp.items()}
        if tp is not None:
            x = remat_tp(remat and torch.is_grad_enabled(), gathered_block,
                         p, p_mlp, x)
        else:
            x = (checkpoint(block, p, p_mlp, x, use_reentrant=False)
                 if remat else block(p, p_mlp, x))
    sh, sc = cat("final_ada", cond_final @ top["final_ada"]).chunk(2, dim=-1)
    x = _modulate(layernorm_noaffine(x), sh, sc)
    return x @ top["out_proj"]


def dit_loss(params, cfg: ArchConfig, batch, abar_full):
    """Denoising score-matching MSE in float32.  batch: {"latents": (B,N,L)
    clean, "t": (B,) int train timesteps, "noise": (B,N,L), "labels": (B,)};
    ``abar_full`` the (n_train,) float32 alpha-bar table on the device.
    On a rank's ``ShardedParams`` the batch is the rank's rows and the
    loss the global batch's mean: its rows' mean averaged over the data
    axes (one all-reduce where they have more than one rank)."""
    from repro_torch import comm

    ab = abar_full[batch["t"].long()][:, None, None].to(torch.float32)
    x_t = torch.sqrt(ab) * batch["latents"] + torch.sqrt(1.0 - ab) \
        * batch["noise"]
    pred = dit_apply(params, cfg, x_t.to(batch["latents"].dtype),
                     batch["t"].to(torch.float32), batch["labels"].long(),
                     remat=True)
    loss = torch.mean(torch.square(pred.to(torch.float32) - batch["noise"]))
    group = params.data_group() if isinstance(params, ShardedParams) \
        else None
    if group is not None and comm.group_size(group) > 1:
        loss = comm.sum_replicated(loss, group) / comm.group_size(group)
    return loss


def tp_train_collectives(cfg: ArchConfig, model: int, data: int,
                         grad_accum: int = 1) -> dict:
    """Collectives of one tensor-parallel train step of the DiT
    (``launch.steps.make_train_step`` on a rank's ``ShardedParams``;
    ``dit_loss`` remats every block) whose heads, MLP and adaLN columns
    divide ``model``, on a float32 tree:

    * a microbatch's forward: the ``dit_apply`` call's (2L all-reduces;
      L + 1 all-gathers over model; L + 1 over data > 1) and the loss's
      mean over data > 1 (1 all-reduce);
    * the recompute of every block in the backward pass: 2 all-reduces
      and 1 all-gather over model, 1 all-gather over data > 1;
    * the backward: 2 all-reduces a block (its attention's and MLP's
      inputs) and 1 of cond (every adaLN product's input); a
      reduce-scatter over data > 1 for each of the L + 1 gathers;
    * the step: the global norm's partial sums all-reduced over model > 1
      and over data > 1 (every leaf is split over the data axes where
      ``d_model`` divides them, so no gradient is all-reduced over data,
      and none is partial over model)."""
    L = cfg.num_layers
    fwd_ag = (L + 1) + (L + 1) * (data > 1)
    fwd_ar = 2 * L + (data > 1)
    rec_ag = L + L * (data > 1)
    rec_ar = 2 * L
    bwd_ar = 2 * L + 1
    bwd_rs = (L + 1) * (data > 1)
    return {"all-gather": grad_accum * (fwd_ag + rec_ag),
            "all-reduce": grad_accum * (fwd_ar + rec_ar + bwd_ar)
            + (model > 1) + (data > 1),
            "reduce-scatter": grad_accum * bwd_rs}


# ---------------------------------------------------------------------------
# DiffusionWrapper: any LM backbone as a latent-sequence denoiser
# ---------------------------------------------------------------------------


def wrapper_defs(cfg: ArchConfig, latent_dim: int) -> Dict:
    """The wrapper's parameter tree: the backbone's (``build_defs``, its
    embedding and head included, as the reference keeps them), the latent
    in/out projections and the timestep MLP.  ``out_proj`` starts at zeros,
    as in the reference: an untrained wrapper returns eps = 0."""
    from repro_torch.models.backbone import build_defs

    d = cfg.d_model
    return {
        "backbone": build_defs(cfg),
        "in_proj": ParamSpec((latent_dim, d), "lecun", latent_dim,
                             axes=(None, "embed")),
        "t_mlp1": ParamSpec((TEMB_DIM, d), "lecun", TEMB_DIM,
                            axes=(None, "embed")),
        "t_mlp2": ParamSpec((d, d), "lecun", d, axes=(None, "embed")),
        "out_proj": ParamSpec((d, latent_dim), "zeros",
                              axes=("embed", None)),
    }


def wrapper_apply(params, cfg: ArchConfig, latents, t, *,
                  remat: bool = False):
    """latents: (B, N, latent_dim); t: (B,) -> eps (B, N, latent_dim).

    The backbone runs in its native mode (causal for attention archs): a
    causal denoiser over latent token sequences (diffusion-forcing style);
    ParaTAA is agnostic to the denoiser's internal structure.  ``remat``
    recomputes each layer in the backward pass.  ``params`` may be a
    rank's ``ShardedParams`` of :func:`wrapper_defs` on a mesh: the
    projections' data-axis splits gathered, the backbone tensor-parallel
    (``models.backbone``); no train step takes the wrapper on a mesh
    (``launch.steps.partial_leaves`` names the DiT's and the LMs'
    leaves)."""
    from repro_torch.models.backbone import (default_positions, seq_split,
                                             trunk)
    from repro_torch.models.shardctx import LayerTP

    tp = params if isinstance(params, ShardedParams) else None
    top = params if tp is None else tp.gather(
        {k: tp.local[k] for k in ("in_proj", "t_mlp1", "t_mlp2",
                                  "out_proj")})
    b, n, _ = latents.shape
    x = latents @ top["in_proj"]
    temb = sinusoidal_embed(t, TEMB_DIM).to(x.dtype)
    cond = F.silu(temb @ top["t_mlp1"]) @ top["t_mlp2"]
    x = x + cond[:, None, :]
    pos = default_positions(cfg, b, n, x.device)
    if tp is None:
        h, _, _ = trunk(params["backbone"], cfg, x, pos, mode="train",
                        remat=remat)
        return h @ params["out_proj"]
    # the backbone tensor-parallel on its blocks: the residual's rows
    # split over model where the arch asks (backbone.seq_split)
    bb = tp.sub("backbone")
    split = seq_split(cfg, bb, "train", n)
    rows = LayerTP(bb, "", {}, split, n)
    h, _, _ = trunk(bb, cfg, rows.own_rows(x), pos, mode="train",
                    remat=remat)
    return rows.rows_whole(h) @ top["out_proj"]
