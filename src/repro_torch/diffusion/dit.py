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
host path's on the same tensors, bit for bit.  The sharded forward is
inference only.
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
from repro_torch.models.shardctx import ShardedParams
from repro_torch.tree import leaves

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
    tree = params
    if tp is not None:
        tree = tp.local
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in leaves(tree)):
            raise NotImplementedError(
                "the tensor-parallel DiT is forward-only: its backward is "
                "ROADMAP Queue 1 item 3, step 2 (the tensor-parallel "
                "backward and the DiT's train_4k cell on a mesh)")

    def full(blocks):
        return tp.gather(blocks) if tp is not None else blocks

    def cat(path, x):
        return tp.model_cat(path, x) if tp is not None else x

    def reduce(path, x):
        return tp.model_sum(path, x) if tp is not None else x

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

    def block(p, p_mlp, x):
        mod = cat("blocks/ada", cond @ p["ada"])
        s1, sc1, g1, s2, sc2, g2 = mod.chunk(6, dim=-1)
        h = _dit_attention(p, _modulate(layernorm_noaffine(x), s1, sc1))
        x = x + g1[:, None, :] * reduce("blocks/wo", h)
        h = mlp(p_mlp, _modulate(layernorm_noaffine(x), s2, sc2), "gelu")
        return x + g2[:, None, :] * reduce("blocks/mlp/wo", h)

    # each stacked (L, ...) leaf split into its layers once: the backward of
    # unbind stacks the layers' grads in one pass, where the backward of
    # indexing the stack per layer fills a zero copy of the whole stack for
    # every layer and sums the L copies (O(L^2) traffic)
    layers = {k: v.unbind(0) for k, v in tree["blocks"].items()
              if k != "mlp"}
    layers_mlp = {k: v.unbind(0) for k, v in tree["blocks"]["mlp"].items()}
    for i in range(cfg.num_layers):
        # a sharded block's embed rows gathered just before it
        whole = full({**{f"blocks/{k}": v[i] for k, v in layers.items()},
                      **{f"blocks/mlp/{k}": v[i]
                         for k, v in layers_mlp.items()}})
        p = {k: whole[f"blocks/{k}"] for k in layers}
        p_mlp = {k: whole[f"blocks/mlp/{k}"] for k in layers_mlp}
        x = (checkpoint(block, p, p_mlp, x, use_reentrant=False) if remat
             else block(p, p_mlp, x))
    sh, sc = cat("final_ada", cond @ top["final_ada"]).chunk(2, dim=-1)
    x = _modulate(layernorm_noaffine(x), sh, sc)
    return x @ top["out_proj"]


def dit_loss(params, cfg: ArchConfig, batch, abar_full):
    """Denoising score-matching MSE in float32.  batch: {"latents": (B,N,L)
    clean, "t": (B,) int train timesteps, "noise": (B,N,L), "labels": (B,)};
    ``abar_full`` the (n_train,) float32 alpha-bar table on the device."""
    ab = abar_full[batch["t"].long()][:, None, None].to(torch.float32)
    x_t = torch.sqrt(ab) * batch["latents"] + torch.sqrt(1.0 - ab) \
        * batch["noise"]
    pred = dit_apply(params, cfg, x_t.to(batch["latents"].dtype),
                     batch["t"].to(torch.float32), batch["labels"].long(),
                     remat=True)
    return torch.mean(torch.square(pred.to(torch.float32) - batch["noise"]))


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
    (``models.backbone``; forward only)."""
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
    rows = LayerTP(bb, "", {}, seq_split(cfg, bb, "train", n), n)
    h, _, _ = trunk(bb, cfg, rows.own_rows(x), pos, mode="train")
    return rows.rows_in(h) @ top["out_proj"]
