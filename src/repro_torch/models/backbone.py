"""Backbone assembly: builds any configured LM architecture from its
ArchConfig (the JAX package's ``repro.models.backbone``): attention, mamba2
(ssm) and RG-LRU blocks, dense or MoE MLPs, and the hybrid layout.

API (plain functions, params are nested dicts/lists of tensors):
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
layers run in a Python loop.  A hybrid stack (recurrentgemma) stacks its
period groups (e.g. rglru, rglru, attn) and keeps the remainder as a list
``tail``.  Train mode recomputes each layer (a hybrid: each period group,
each tail layer) in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``).  Prefill and decode write the cache in
place.
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
from repro_torch.models.mamba2 import init_mamba_cache, mamba_apply, \
    mamba_def
from repro_torch.models.moe import moe_apply, moe_def
from repro_torch.models.pdefs import ParamSpec, stack_defs
from repro_torch.models.rglru import init_rglru_cache, rglru_apply, \
    rglru_def

# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------


def _layer_def(cfg: ArchConfig, kind: str):
    if kind == "ssm":
        return {"norm": rmsnorm_def(cfg.d_model), "mamba": mamba_def(cfg)}
    d = {"norm1": rmsnorm_def(cfg.d_model), "norm2": rmsnorm_def(cfg.d_model)}
    if kind == "attn":
        d["attn"] = attention_def(cfg)
    else:  # rglru
        d["rec"] = rglru_def(cfg)
    if cfg.is_moe:
        d["moe"] = moe_def(cfg)
    elif cfg.d_ff:
        d["mlp"] = mlp_def(cfg.d_model, cfg.d_ff)
    return d


def hybrid_layout(cfg: ArchConfig):
    """(kinds of a period group, number of groups, kinds of the tail)."""
    kinds = cfg.layer_kinds()
    period = cfg.rglru_ratio
    n_per = cfg.num_layers // period
    return kinds[:period], n_per, kinds[n_per * period:]


def build_defs(cfg: ArchConfig):
    d = cfg.d_model
    defs = {
        "embed": ParamSpec((cfg.vocab_size, d), "normal",
                           scale=1.0 / math.sqrt(d), axes=("vocab", "embed")),
        "final_norm": rmsnorm_def(d),
    }
    if cfg.is_hybrid:
        group_kinds, n_per, tail_kinds = hybrid_layout(cfg)
        defs["periods"] = stack_defs(
            {f"l{j}": _layer_def(cfg, k) for j, k in enumerate(group_kinds)},
            n_per)
        defs["tail"] = [_layer_def(cfg, k) for k in tail_kinds]
    else:
        defs["layers"] = stack_defs(_layer_def(cfg, cfg.layer_kinds()[0]),
                                    cfg.num_layers)
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamSpec((d, cfg.vocab_size), "lecun", d,
                                    axes=("embed", "vocab"))
    return defs


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                 dtype, device):
    if kind == "ssm":
        return init_mamba_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, dtype, device)
    window = cfg.window_size if cfg.attention_kind == "swa" else 0
    return init_attn_cache(cfg, batch, max_seq, window, dtype, device)


def _stacked(one, n: int):
    return {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=v.device)
            for k, v in one.items()}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """The cache on ``device``, zeros, index 0: stacked (L, ...) leaves,
    or for a hybrid {"periods": {"l0": stacked, ...}, "tail": [...]}, the
    reference's structure."""
    def one(kind):
        return _layer_cache(cfg, kind, batch, max_seq, dtype, device)
    if cfg.is_hybrid:
        group_kinds, n_per, tail_kinds = hybrid_layout(cfg)
        return {"periods": {f"l{j}": _stacked(one(k), n_per)
                            for j, k in enumerate(group_kinds)},
                "tail": [one(k) for k in tail_kinds]}
    return _stacked(one(cfg.layer_kinds()[0]), cfg.num_layers)


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


def _add(total, aux):
    return aux if total is None else total if aux is None else total + aux


def _apply_layer(cfg: ArchConfig, kind: str, params, h, positions, *,
                 mode: str, cache, causal: bool):
    """-> (h, MoE aux loss or None); the cache is written in place."""
    if kind == "ssm":
        y, _ = mamba_apply(params["mamba"], cfg,
                           rmsnorm(params["norm"], h, cfg.norm_eps),
                           mode=mode, cache=cache)
        return h + y, None
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    if kind == "attn":
        window = cfg.window_size if cfg.attention_kind == "swa" else 0
        y, _ = attention(params["attn"], cfg, x, positions, window=window,
                         causal=causal, cache=cache, mode=mode)
    else:  # rglru
        y, _ = rglru_apply(params["rec"], cfg, x, mode=mode, cache=cache)
    h = h + y
    x2 = rmsnorm(params["norm2"], h, cfg.norm_eps)
    if cfg.is_moe:
        y2, aux = moe_apply(params["moe"], cfg, x2)
        return h + y2, aux
    return h + mlp(params["mlp"], x2, cfg.act), None


def _apply_group(cfg: ArchConfig, kinds, params, h, positions, *, mode: str,
                 cache, causal: bool):
    """A hybrid period group: its layers l0, l1, ... in order."""
    aux = None
    for j, kind in enumerate(kinds):
        h, a = _apply_layer(cfg, kind, params[f"l{j}"], h, positions,
                            mode=mode, causal=causal,
                            cache=cache[f"l{j}"] if cache is not None
                            else None)
        aux = _add(aux, a)
    return h, aux


def trunk(params, cfg: ArchConfig, h, positions, *, mode: str = "train",
          cache=None, causal: bool = True, remat: Optional[bool] = None):
    """h: (B, S, d) -> (h_out, cache, aux_loss).  ``remat`` (default: train
    mode) recomputes each layer (a hybrid's period group) in the backward
    pass; it applies only where autograd records."""
    if remat is None:
        remat = mode == "train"
    remat = remat and torch.is_grad_enabled()

    def run(fn, *args, **kw):
        if remat:
            return checkpoint(fn, *args, **kw, use_reentrant=False)
        return fn(*args, **kw)

    aux = None
    if cfg.is_hybrid:
        group_kinds, n_per, tail_kinds = hybrid_layout(cfg)
        caches = _unstack(cache["periods"], n_per) if cache is not None \
            else [None] * n_per
        for gp, gc in zip(_unstack(params["periods"], n_per), caches):
            h, a = run(_apply_group, cfg, group_kinds, gp, h, positions,
                       mode=mode, cache=gc, causal=causal)
            aux = _add(aux, a)
        for j, kind in enumerate(tail_kinds):
            h, a = run(_apply_layer, cfg, kind, params["tail"][j], h,
                       positions, mode=mode,
                       cache=cache["tail"][j] if cache is not None else None,
                       causal=causal)
            aux = _add(aux, a)
    else:
        L, kind = cfg.num_layers, cfg.layer_kinds()[0]
        caches = _unstack(cache, L) if cache is not None else [None] * L
        for lp, lc in zip(_unstack(params["layers"], L), caches):
            h, a = run(_apply_layer, cfg, kind, lp, h, positions, mode=mode,
                       cache=lc, causal=causal)
            aux = _add(aux, a)
    if aux is None:
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
    h = F.embedding(inputs, params["embed"])
    if cfg.is_hybrid:
        # gemma-style scaling by sqrt(d), the factor itself rounded to the
        # activations' dtype first, as the reference rounds it (50.5 in bf16
        # for d = 2560)
        h = h * float(torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype))
    return h


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


def cache_index(cfg: ArchConfig, cache):
    """The tokens written so far: the first layer's device int32 index
    (the same in every layer; a hybrid's from its first period group)."""
    return (cache["periods"]["l0"] if cfg.is_hybrid else cache)["index"][0]


def decode_step(params, cfg: ArchConfig, token, cache):
    """One decoding step.  token: (B, 1) ids (or (B, 1, d) embeds for stub
    frontends).  Returns (logits (B, 1, V), cache), the cache written in
    place; the position is the cache's device index (no host read)."""
    b = token.shape[0]
    # absolute position = cache index; a copy, since each layer advances
    # its own index in place
    pos = cache_index(cfg, cache).clone().view(1, 1).expand(b, 1)
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
    h, _, aux = trunk(params, cfg, h,
                      default_positions(cfg, b, s, inputs.device),
                      mode="train")
    nll = _chunked_xent(h, head_weight(params, cfg), batch["labels"],
                        cfg.logit_softcap)
    if cfg.is_moe:
        nll = nll + 0.01 * aux / cfg.num_layers
    return nll
