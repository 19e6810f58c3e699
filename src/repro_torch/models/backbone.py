"""Backbone assembly: builds an attention-family architecture from its
ArchConfig (the JAX package's ``repro.models.backbone``).

API (plain functions, params are nested dicts of tensors):
  build_defs(cfg)                          -> ParamSpec tree
  forward(params, cfg, tokens/embeds)      -> (logits, aux)   (train shapes)
  prefill(params, cfg, inputs, cache)      -> (logits, cache)
  decode_step(params, cfg, token, cache)   -> (logits, cache)
  trunk(...)                               -> hidden states   (used by the
                                              DiffusionWrapper denoiser)
  init_cache(cfg, batch, max_seq, dtype, device)
  lm_loss(params, cfg, batch)              -> scalar

Layers are stacked on a leading axis, as the reference's scan carries
them; each stacked leaf is split into its layers once (``unbind``) and the
layers run in a Python loop.  Train mode recomputes each layer in the
backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).  Prefill and decode write the stacked cache in place.

Only attention blocks with a dense MLP are ported: a config with mamba2
(ssm) or RG-LRU layers, or with MoE, raises NotImplementedError.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attention, attention_def, \
    init_attn_cache
from repro_torch.models.layers import mlp, mlp_def, rmsnorm, rmsnorm_def
from repro_torch.models.pdefs import ParamSpec, stack_defs

#: where the blocks this module lacks are queued
NOT_PORTED = "ROADMAP Queue 1 item 3b"


def check_ported(cfg: ArchConfig) -> None:
    """Raises NotImplementedError for a config with ssm, rglru or MoE
    blocks."""
    other = sorted(set(cfg.layer_kinds()) - {"attn"})
    if other or cfg.is_moe:
        what = other + (["moe"] if cfg.is_moe else [])
        raise NotImplementedError(
            f"{cfg.name}: {'/'.join(what)} blocks are not ported yet; only "
            f"the attention-family backbones are ({NOT_PORTED})")


# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------


def _layer_def(cfg: ArchConfig):
    d = {"norm1": rmsnorm_def(cfg.d_model), "norm2": rmsnorm_def(cfg.d_model),
         "attn": attention_def(cfg)}
    if cfg.d_ff:
        d["mlp"] = mlp_def(cfg.d_model, cfg.d_ff)
    return d


def build_defs(cfg: ArchConfig):
    check_ported(cfg)
    d = cfg.d_model
    defs = {
        "embed": ParamSpec((cfg.vocab_size, d), "normal",
                           scale=1.0 / math.sqrt(d)),
        "final_norm": rmsnorm_def(d),
        "layers": stack_defs(_layer_def(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamSpec((d, cfg.vocab_size), "lecun", d)
    return defs


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """The stacked (L, ...) cache on ``device``, zeros, index 0."""
    check_ported(cfg)
    window = cfg.window_size if cfg.attention_kind == "swa" else 0
    one = init_attn_cache(cfg, batch, max_seq, window, dtype, device)
    return {k: torch.zeros((cfg.num_layers,) + v.shape, dtype=v.dtype,
                           device=v.device) for k, v in one.items()}


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _unstack(tree, n: int):
    """A tree of stacked (n, ...) tensors -> n trees of views, each leaf
    split once: the backward of ``unbind`` stacks the layers' grads in one
    pass, where indexing the stack per layer fills a zero copy of the
    whole stack for every layer."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return tree.unbind(0)


def _apply_layer(cfg: ArchConfig, params, h, positions, *, mode: str, cache,
                 causal: bool):
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    window = cfg.window_size if cfg.attention_kind == "swa" else 0
    y, new_cache = attention(params["attn"], cfg, x, positions, window=window,
                             causal=causal, cache=cache, mode=mode)
    h = h + y
    x2 = rmsnorm(params["norm2"], h, cfg.norm_eps)
    return h + mlp(params["mlp"], x2, cfg.act), new_cache


def trunk(params, cfg: ArchConfig, h, positions, *, mode: str = "train",
          cache=None, causal: bool = True, remat: Optional[bool] = None):
    """h: (B, S, d) -> (h_out, cache, aux_loss).  ``remat`` (default: train
    mode) recomputes each layer in the backward pass; it applies only where
    autograd records."""
    check_ported(cfg)
    if remat is None:
        remat = mode == "train"
    remat = remat and torch.is_grad_enabled()
    L = cfg.num_layers
    caches = _unstack(cache, L) if cache is not None else [None] * L
    for lp, lc in zip(_unstack(params["layers"], L), caches):
        if remat:
            h, _ = checkpoint(_apply_layer, cfg, lp, h, positions, mode=mode,
                              cache=lc, causal=causal, use_reentrant=False)
        else:
            h, _ = _apply_layer(cfg, lp, h, positions, mode=mode, cache=lc,
                                causal=causal)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), cache, aux


# ---------------------------------------------------------------------------
# Embedding / head / full passes
# ---------------------------------------------------------------------------


def embed(params, cfg: ArchConfig, inputs):
    """Token ids (B,S) int -> (B,S,d); or precomputed embeddings passed
    through for stub-frontend archs (float inputs of shape (B,S,d))."""
    if inputs.is_floating_point():
        if cfg.frontend != "embed":
            raise ValueError(f"{cfg.name}: float inputs need frontend="
                             f"'embed', not {cfg.frontend!r}")
        return inputs
    return F.embedding(inputs, params["embed"])


def head_weight(params, cfg: ArchConfig):
    """(d, V): the tied embedding's transpose, or ``lm_head``."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def unembed(params, cfg: ArchConfig, h):
    logits = h @ head_weight(params, cfg)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def default_positions(cfg: ArchConfig, batch: int, seq: int, device,
                      offset: int = 0):
    """(B, S) int32 positions offset..offset+S-1, or their three (t, h, w)
    copies (3, B, S) for M-RoPE; made on the device."""
    pos = torch.arange(offset, offset + seq, dtype=torch.int32,
                       device=device)[None, :].expand(batch, seq)
    return pos[None].expand(3, batch, seq) if cfg.m_rope else pos


def forward(params, cfg: ArchConfig, inputs, positions=None, *, remat=None):
    """Train-shape forward: inputs -> (logits (B, S, V), aux)."""
    b, s = inputs.shape[:2]
    if positions is None:
        positions = default_positions(cfg, b, s, inputs.device)
    h = embed(params, cfg, inputs)
    h, _, aux = trunk(params, cfg, h, positions, mode="train", remat=remat)
    return unembed(params, cfg, h), aux


def prefill(params, cfg: ArchConfig, inputs, cache, positions=None, *,
            last_only: bool = True):
    """Process a prompt, filling ``cache`` in place.  Returns (logits,
    cache); ``last_only`` unembeds just the final position."""
    b, s = inputs.shape[:2]
    if positions is None:
        positions = default_positions(cfg, b, s, inputs.device)
    h = embed(params, cfg, inputs)
    h, cache, _ = trunk(params, cfg, h, positions, mode="prefill",
                        cache=cache, remat=False)
    if last_only:
        h = h[:, -1:]
    return unembed(params, cfg, h), cache


def decode_step(params, cfg: ArchConfig, token, cache):
    """One decoding step.  token: (B, 1) ids (or (B, 1, d) embeds for stub
    frontends).  Returns (logits (B, 1, V), cache), the cache written in
    place; the position is the cache's device index (no host read)."""
    b = token.shape[0]
    # absolute position = cache index (the same in every layer); a copy,
    # since each layer advances its own index in place
    pos = cache["index"][0].clone().view(1, 1).expand(b, 1)
    positions = pos[None].expand(3, b, 1) if cfg.m_rope else pos
    h = embed(params, cfg, token)
    h, cache, _ = trunk(params, cfg, h, positions, mode="decode",
                        cache=cache, remat=False)
    return unembed(params, cfg, h), cache


# ---------------------------------------------------------------------------
# Loss (LM pretraining objective)
# ---------------------------------------------------------------------------


N_CE_CHUNKS = 8  # batch-chunked cross entropy: one chunk of float32
                 # logits live at a time instead of (B, S, V)


def _xent_sum(hc, w, lc, softcap: float):
    logits = (hc @ w).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc.long()[..., None])[..., 0]
    return (logz - gold).sum()


def _chunked_xent(h, w, labels, softcap: float):
    """h: (B,S,d); w: (d,V); labels: (B,S).  Cross entropy over batch
    chunks, each recomputed in the backward pass (``checkpoint``): the
    full (B,S,V) float32 logits never exist."""
    b, s, _ = h.shape
    nc = N_CE_CHUNKS
    while nc > 1 and b % nc:
        nc //= 2
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for hc, lc in zip(h.chunk(nc), labels.chunk(nc)):
        if torch.is_grad_enabled():
            total = total + checkpoint(_xent_sum, hc, w, lc, softcap,
                                       use_reentrant=False)
        else:
            total = total + _xent_sum(hc, w, lc, softcap)
    return total / (b * s)


def lm_loss(params, cfg: ArchConfig, batch):
    """batch: {"inputs": (B,S) ids or (B,S,d) embeds, "labels": (B,S)}."""
    inputs = batch["inputs"]
    b, s = inputs.shape[:2]
    h = embed(params, cfg, inputs)
    h, _, _ = trunk(params, cfg, h,
                    default_positions(cfg, b, s, inputs.device), mode="train")
    return _chunked_xent(h, head_weight(params, cfg), batch["labels"],
                         cfg.logit_softcap)
