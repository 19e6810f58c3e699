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

Tensor parallel: given a rank's ``shardctx.ShardedParams`` of
``build_defs`` and a ``shardctx.ShardedCache`` (``launch.steps.
local_cache``), ``forward``/``prefill``/``decode_step``/``lm_loss`` run
the reference's layout, and ``lm_loss`` and ``forward`` differentiate
under grad (each collective's backward is ``comm``'s form for its call
site; train mode recomputes each layer, its gather and collectives
included, in the backward pass).  Outside decode, for ``tp_strategy=
"hidden"`` archs and ``seq_parallel`` ones, the residual between
sublayers is the rank's rows over ``model`` (:func:`seq_split`; the
reference's ``constrain(h, "batch", "seq", None)``); elsewhere it is
whole over ``model``.  Each layer's leaves are gathered over the data
axes just before it (``ShardedParams.gather``), and each sublayer reads
its split through a ``shardctx.LayerTP``.  The embedding is
vocab-parallel (a rank looks up its vocab rows, zeros elsewhere, summed
over ``model``: all-reduced, or reduce-scattered into the rank's rows
under a split) and the head column-parallel (its vocab columns
all-gathered); where the vocab does not divide ``model`` both stay whole
and nothing is reduced.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import comm
from repro_torch.configs.base import ArchConfig
from repro_torch.models import rglru
from repro_torch.models.attention import attention, attention_def, \
    init_attn_cache
from repro_torch.models.layers import mlp, mlp_def, rmsnorm, rmsnorm_def
from repro_torch.models.mamba2 import init_mamba_cache, mamba_apply, \
    mamba_def
from repro_torch.models.moe import moe_apply, moe_def
from repro_torch.models.pdefs import ParamSpec, stack_defs
from repro_torch.models.rglru import init_rglru_cache, rglru_apply, \
    rglru_def
from repro_torch.models.shardctx import (LayerTP, ShardedCache, ShardedParams,
                                         remat_tp)

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
                 mode: str, cache, causal: bool, tp: Optional[LayerTP] = None):
    """-> (h, MoE aux loss or None); the cache is written in place.
    ``tp``: the layer's tensor-parallel view (``params`` its blocks,
    ``h`` the residual's layout; under a row split the norms see each
    rank's rows, so their gradients are partial: :func:`partial_leaves`)."""
    if kind == "ssm":
        y, _ = mamba_apply(params["mamba"], cfg,
                           rmsnorm(params["norm"], h, cfg.norm_eps),
                           mode=mode, cache=cache, tp=tp)
        return h + y, None
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    if kind == "attn":
        window = cfg.window_size if cfg.attention_kind == "swa" else 0
        y, _ = attention(params["attn"], cfg, x, positions, window=window,
                         causal=causal, cache=cache, mode=mode, tp=tp)
    else:  # rglru
        y, _ = rglru_apply(params["rec"], cfg, x, mode=mode, cache=cache,
                           tp=tp)
    h = h + y
    x2 = rmsnorm(params["norm2"], h, cfg.norm_eps)
    if cfg.is_moe:
        y2, aux = moe_apply(params["moe"], cfg, x2, tp=tp, mode=mode)
        return h + y2, aux
    if tp is None:
        return h + mlp(params["mlp"], x2, cfg.act), None
    return h + tp.rows_out("mlp/wo", mlp(params["mlp"],
                                         tp.rows_in(x2, "mlp/wo"),
                                         cfg.act)), None


def _apply_group(cfg: ArchConfig, kinds, params, h, positions, *, mode: str,
                 cache, causal: bool, tps=None):
    """A hybrid period group: its layers l0, l1, ... in order (``tps``:
    their tensor-parallel views)."""
    aux = None
    for j, kind in enumerate(kinds):
        h, a = _apply_layer(cfg, kind, params[f"l{j}"], h, positions,
                            mode=mode, causal=causal,
                            cache=cache[f"l{j}"] if cache is not None
                            else None,
                            tp=tps[j] if tps is not None else None)
        aux = _add(aux, a)
    return h, aux


def trunk(params, cfg: ArchConfig, h, positions, *, mode: str = "train",
          cache=None, causal: bool = True, remat: Optional[bool] = None):
    """h: (B, S, d) -> (h_out, cache, aux_loss).  ``remat`` (default: train
    mode) recomputes each layer (a hybrid's period group) in the backward
    pass; it applies only where autograd records.  On a rank's
    ``ShardedParams`` (and ``ShardedCache``): :func:`_trunk_tp`."""
    if remat is None:
        remat = mode == "train"
    remat = remat and torch.is_grad_enabled()
    if isinstance(params, ShardedParams):
        return _trunk_tp(params, cfg, h, positions, mode=mode, cache=cache,
                         causal=causal, remat=remat)

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


def seq_split(cfg: ArchConfig, tp, mode: str, s: int) -> bool:
    """Whether the residual's ``s`` rows are split over ``model`` on the
    rank's blocks ``tp`` (the reference's ``seq`` constraint: hidden-TP
    and ``seq_parallel`` archs outside decode, where ``model`` divides
    the rows)."""
    return (tp is not None and mode != "decode"
            and (cfg.tp_strategy == "hidden" or cfg.seq_parallel)
            and s % tp.model_size == 0)


#: a layer's sublayers and the leaf whose split over ``model`` makes the
#: sublayer take its input through ``LayerTP.rows_in``'s partial form
SUBLAYER_SPLIT_LEAF = {"attn": "wq", "mlp": "wo", "mamba": "in_x",
                       "rec": "w_o", "moe": "we_gate"}


def partial_leaves(cfg: ArchConfig, tp: ShardedParams, s: int) -> set:
    """The paths of the leaves held whole over ``model`` > 1 whose
    gradients are each rank's partial in a train step on ``s`` tokens
    (``ShardedParams.sync_grads`` all-reduces them over ``model``): under
    :func:`seq_split` every whole leaf (each rank computes on its own rows,
    and a context-parallel attention's keys come gathered from every
    rank's); else the whole leaves of each sublayer whose
    :data:`SUBLAYER_SPLIT_LEAF` is split (its input's gradient is
    all-reduced after the sublayer: attention's ``q_norm``/``k_norm`` and
    KV leaves where KV does not divide, mamba2's B/C projections and
    norm, the MoE router and a whole shared MLP)."""
    if tp.model_size == 1:
        return set()
    split = seq_split(cfg, tp, "train", s)
    out = set()
    for path in tp.specs:
        if tp.sharded(path):
            continue
        parts = path.split("/")
        if split or any(
                p in SUBLAYER_SPLIT_LEAF and tp.sharded(
                    "/".join(parts[:i + 1] + [SUBLAYER_SPLIT_LEAF[p]]))
                for i, p in enumerate(parts[:-1])):
            out.add(path)
    return out


def tp_collectives(cfg: ArchConfig, mode: str, model: int, data: int,
                   s: int, cap: int = 0) -> dict:
    """Collectives of one tensor-parallel call (``mode`` train, prefill or
    decode; ``s`` tokens; ``cap`` the attention cache's slots) whose
    ``mlp``, ``expert``, ``inner`` and ``ssm_heads`` dims divide ``model``:

    * the embedding: 1 reduction over model where the vocab divides it
      (a reduce-scatter under a row split, else an all-reduce); the head
      1 all-gather of the vocab columns, and under a row split 1 more of
      the rows (the last row's for a ``last_only`` prefill);
    * the residual's rows are split (hidden / seq_parallel, outside
      decode, ``s`` divisible): each model-sharded sublayer all-gathers
      the rows in and reduce-scatters its output; unsplit, it all-reduces
      its output;
    * attention: heads — its ``wo`` output over model (all-gather of the
      rows first under seq_parallel); hidden — 1 all-gather of k and v
      under a row split and no output reduction; decode on a cache split
      over slots: 1 all-reduce of the max and 1 of the sums and contexts,
      the q heads all-gathered first under heads (whose ``wo`` output is
      then all-reduced); on a cache split over KV heads: under hidden
      with model > 1, the rank's heads' output all-reduced;
    * mamba2: 1 all-reduce of the gated norm's sum of squares, with a
      cache 1 all-gather of the conv_B/conv_C carries (model > 1);
      RG-LRU: 1 all-gather of the shared gate block's inputs where model
      does not divide ``rglru.NUM_GATE_BLOCKS``; each their
      ``out``/``w_o`` reduction;
    * the MLP, or the MoE's experts and shared MLP together: 1 reduction;
      in train mode the MoE's aux loss all-reduced over data > 1;
    * over data > 1: one flat all-gather of the embed rows a layer (a
      hybrid's period group, a tail layer) and one of the top leaves, a
      dtype each (a bf16 MoE layer's float32 router moves in a second).

    The formula the tests and ``chip_smoke.py`` hold the counted
    collectives (``repro_torch.comm``) to, for float32 trees."""
    H, KV, V = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size
    split = mode != "decode" and (cfg.tp_strategy == "hidden"
                                  or cfg.seq_parallel) and s % model == 0
    heads = cfg.tp_strategy == "heads"
    c = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}
    out_kind = "reduce-scatter" if split else "all-reduce"
    if cfg.frontend != "embed" and V % model == 0:
        c[out_kind] += 1
    c["all-gather"] += (V % model == 0) + split
    for kind in cfg.layer_kinds():
        if kind == "attn":
            if mode != "decode":
                c["all-gather"] += split
                if heads and H % model == 0:
                    c[out_kind] += 1
            elif KV % model and cap % model == 0:       # slots split
                c["all-gather"] += heads and H % model == 0
                c["all-reduce"] += 2 + (heads and H % model == 0)
            elif heads and H % model == 0:
                c["all-reduce"] += 1
            elif not heads and KV % model == 0 and model > 1:
                c["all-reduce"] += 1
        elif kind == "ssm":
            gn = cfg.ssm_ngroups * cfg.ssm_state
            c["all-gather"] += split + (mode != "train" and model > 1
                                        and gn % model == 0)
            c["all-reduce"] += 1
            c[out_kind] += 1
        else:
            c["all-gather"] += split + (rglru.NUM_GATE_BLOCKS % model != 0)
            c[out_kind] += 1
        if kind != "ssm":
            c["all-gather"] += split
            c[out_kind] += 1
            c["all-reduce"] += cfg.is_moe and mode == "train" and data > 1
    if data > 1:
        if cfg.is_hybrid:
            _, n_per, tail = hybrid_layout(cfg)
            units = n_per + len(tail)
        else:
            units = cfg.num_layers
        c["all-gather"] += units + 1
    return c


def _replicated_over_data(defs, data: int) -> bool:
    """Whether some leaf of ``defs`` is replicated over a data axis of
    ``data`` ranks (its gradient then all-reduced over data)."""
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.models.pdefs import resolve_spec, walk

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           mesh=np.zeros((data, 1)))
    return data > 1 and any("data" not in resolve_spec(spec, mesh)
                            for _, spec in walk(defs))


def tp_train_collectives(cfg: ArchConfig, model: int, data: int, s: int,
                         grad_accum: int = 1) -> dict:
    """Collectives of one tensor-parallel train step
    (``launch.steps.make_train_step`` on a rank's ``ShardedParams``; ``s``
    tokens, ``grad_accum`` microbatches; float32; every ``mlp``,
    ``expert``, ``inner`` and ``ssm_heads`` dim divides ``model``).  A
    microbatch's ``lm_loss`` calls:

    * forward: :func:`tp_collectives`'s train-mode call, without the
      head's vocab all-gather: the loss is a vocab-parallel cross entropy
      over model > 1 (the max and the sums, 2 all-reduces; with a whole
      head, 1 of each rank's rows' sum under a split); the loss's mean over
      data > 1 (1 all-reduce);
    * the recompute of every unit (a layer, a hybrid's period group or
      tail layer) in the backward pass: the unit's forward collectives
      again, its data-axis gather included;
    * the backward, each forward collective's adjoint (``comm``'s table):
      a reduce-scatter for each gather of rows into split leaves, of keys
      and of shared gate-block inputs, and for each data-axis gather; an
      all-gather for each reduce-scatter of rows; an all-reduce for each
      sublayer input entering split leaves unsplit (attention's under
      ``heads``, the MLP's, MoE's, mamba2's, the RG-LRU's, the head's) and
      for mamba2's gated norm; none for a sum of partials (its gradient
      passes through).

    The step adds the gradient sync — 1 all-reduce over data > 1 of the
    leaves it does not split, 1 over model > 1 of the whole leaves with
    partial gradients (every split layer's norms, attention's ``q_norm``/
    ``k_norm`` and unsplit KV leaves, mamba2's B/C projections and norm,
    the MoE router) — and the global norm's (1 over model > 1, 1 over
    data > 1)."""
    H, KV, V = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size
    split = (cfg.tp_strategy == "hidden" or cfg.seq_parallel) \
        and s % model == 0
    heads = cfg.tp_strategy == "heads"
    head_split = V % model == 0
    c = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}

    def add(counts, n=1):
        for k, v in counts.items():
            c[k] += n * v

    fwd = tp_collectives(cfg, "train", model, data, s)
    # no logits gathered; a whole head reads each rank's own rows
    fwd["all-gather"] -= head_split + (split and not head_split)
    units = 0
    if data > 1:
        _, n_per, tail = hybrid_layout(cfg) if cfg.is_hybrid else \
            (None, cfg.num_layers, ())
        units = n_per + len(tail)
    # the units' forward (recomputed): everything but the embedding, the
    # head and the top leaves' gather
    rec = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}
    bwd = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}
    out_kind = "reduce-scatter" if split else "all-reduce"
    for kind in cfg.layer_kinds():
        # a sublayer's input entering split leaves: a gather (-> RS) under
        # a split, else an all-reduce of its gradient; its output's
        # reduce-scatter -> AG
        def sublayer(sharded: bool):
            if split:
                rec["all-gather"] += 1
                bwd["reduce-scatter"] += 1
            elif sharded:
                bwd["all-reduce"] += 1
            if sharded:
                rec[out_kind] += 1
                bwd["all-gather"] += split
        if kind == "attn":
            if heads:
                sublayer(H % model == 0)
            elif split:                         # context parallel keys
                rec["all-gather"] += 1
                bwd["reduce-scatter"] += 1
        elif kind == "ssm":
            sublayer(True)
            rec["all-reduce"] += 1
            bwd["all-reduce"] += 1
        else:
            sublayer(True)
            if rglru.NUM_GATE_BLOCKS % model:
                rec["all-gather"] += 1
                bwd["reduce-scatter"] += 1
        if kind != "ssm":
            sublayer(True)
            rec["all-reduce"] += cfg.is_moe and data > 1
    rec["all-gather"] += units
    bwd["reduce-scatter"] += units + (data > 1)       # and the top leaves'
    if cfg.frontend != "embed" and head_split and split:
        bwd["all-gather"] += 1                        # the embedding's RS
    if head_split:                                    # the head's input
        bwd["reduce-scatter" if split else "all-reduce"] += 1
        fwd["all-reduce"] += 2 * (model > 1)
    else:
        fwd["all-reduce"] += split
    fwd["all-reduce"] += data > 1
    add(fwd, grad_accum)
    add(rec, grad_accum)
    add(bwd, grad_accum)
    partial = model > 1 and (
        split or cfg.is_moe or "ssm" in cfg.layer_kinds()
        or ("attn" in cfg.layer_kinds() and heads and H % model == 0
            and (cfg.qk_norm or KV % model != 0)))
    c["all-reduce"] += _replicated_over_data(build_defs(cfg), data) \
        + partial + (model > 1) + (data > 1)
    return c


def _trunk_tp(tp: ShardedParams, cfg: ArchConfig, h, positions, *,
              mode: str, cache: Optional[ShardedCache], causal: bool,
              remat: bool = False):
    """The trunk on a rank's blocks: ``h`` in the residual's layout (the
    rank's rows under :func:`seq_split`), ``positions`` every row's;
    returns the final-norm h in the same layout.  ``remat`` recomputes
    each unit (a layer, a hybrid's period group or tail layer) — its
    data-axis gather included — in the backward pass."""
    s = positions.shape[-1]
    split = seq_split(cfg, tp, mode, s)
    specs = cache.specs if cache is not None else {}
    tree = tp.local
    local = cache.local if cache is not None else None

    def view(prefix: str, cprefix: str, stacked: bool) -> LayerTP:
        own = {k[len(cprefix):]: (e[1:] if stacked else e)
               for k, e in specs.items() if k.startswith(cprefix)
               and "/" not in k[len(cprefix):]}
        return LayerTP(tp, prefix, own, split, s)

    aux = None
    if cfg.is_hybrid:
        group_kinds, n_per, tail_kinds = hybrid_layout(cfg)
        caches = _unstack(local["periods"], n_per) if local is not None \
            else [None] * n_per
        tps = [view(f"periods/l{j}/", f"periods/l{j}/", True)
               for j in range(len(group_kinds))]

        def group(gp, h, gc):
            return _apply_group(cfg, group_kinds,
                                tp.gather_tree("periods/", gp), h,
                                positions, mode=mode, cache=gc,
                                causal=causal, tps=tps)
        for gp, gc in zip(_unstack(tree["periods"], n_per), caches):
            h, a = remat_tp(remat, group, gp, h, gc)
            aux = _add(aux, a)
        for j, kind in enumerate(tail_kinds):
            def tail(lp, h, lc, j=j, kind=kind):
                return _apply_layer(
                    cfg, kind, tp.gather_tree(f"tail/{j}/", lp), h,
                    positions, mode=mode, cache=lc, causal=causal,
                    tp=view(f"tail/{j}/", f"tail/{j}/", False))
            h, a = remat_tp(remat, tail, tree["tail"][j], h,
                            local["tail"][j] if local is not None else None)
            aux = _add(aux, a)
    else:
        L, kind = cfg.num_layers, cfg.layer_kinds()[0]
        caches = _unstack(local, L) if local is not None else [None] * L
        ltp = view("layers/", "", True)

        def layer(lp, h, lc):
            return _apply_layer(cfg, kind, tp.gather_tree("layers/", lp),
                                h, positions, mode=mode, cache=lc,
                                causal=causal, tp=ltp)
        for lp, lc in zip(_unstack(tree["layers"], L), caches):
            h, a = remat_tp(remat, layer, lp, h, lc)
            aux = _add(aux, a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    norm = tp.gather_tree("final_norm/", tree["final_norm"])
    return rmsnorm(norm, h, cfg.norm_eps), cache, aux


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


def _top(tp: ShardedParams, cfg: ArchConfig) -> dict:
    """The embedding (and the untied head) with their data-axis splits
    all-gathered."""
    keys = ["embed"] if cfg.tie_embeddings else ["embed", "lm_head"]
    return tp.gather({k: tp.local[k] for k in keys})


def _rows(tp: ShardedParams, split: bool, s: int) -> LayerTP:
    return LayerTP(tp, "", {}, split, s)


def _embed_tp(tp: ShardedParams, cfg: ArchConfig, top: dict, inputs,
              split: bool):
    """The vocab-parallel lookup in the residual's layout (the module
    docstring)."""
    rows = _rows(tp, split, inputs.shape[1])
    if inputs.is_floating_point():
        return rows.own_rows(embed(top, cfg, inputs))
    w = top["embed"]
    if not tp.sharded("embed"):
        return rows.own_rows(embed(top, cfg, inputs))
    v = w.shape[0]
    ids = inputs.long() - tp.model_rank * v
    hit = (ids >= 0) & (ids < v)
    h = torch.where(hit[..., None], F.embedding(ids.clamp(0, v - 1), w),
                    torch.zeros((), dtype=w.dtype, device=w.device))
    h = comm.scatter_sum(h, tp.model_group, 1) if split else \
        comm.sum_replicated(h, tp.model_group)
    if cfg.is_hybrid:
        h = h * float(torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype))
    return h


def _head(cfg: ArchConfig) -> str:
    return "embed" if cfg.tie_embeddings else "lm_head"


def _unembed_tp(tp: ShardedParams, cfg: ArchConfig, top: dict, h,
                split: bool = False, s: int = 0):
    """Column-parallel logits of ``h`` (the rank's rows under ``split``,
    ``s`` rows in all: every row's logits), the vocab columns all-gathered
    over ``model``."""
    rows = _rows(tp, split, s)
    if tp.sharded(_head(cfg)):
        logits = tp.model_cat(_head(cfg), rows.rows_in(h, _head(cfg))
                              @ head_weight(top, cfg), -1)
    else:                       # a whole head: each rank's rows' logits
        logits = rows.rows_whole(h @ head_weight(top, cfg))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


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
    """Train-shape forward: inputs -> (logits (B, S, V), aux).  On a
    rank's ``ShardedParams``: its data shard's logits."""
    b, s = inputs.shape[:2]
    if positions is None:
        positions = default_positions(cfg, b, s, inputs.device)
    if isinstance(params, ShardedParams):
        split = seq_split(cfg, params, "train", s)
        top = _top(params, cfg)
        h = _embed_tp(params, cfg, top, inputs, split)
        h, _, aux = trunk(params, cfg, h, positions, mode="train",
                          remat=remat)
        return _unembed_tp(params, cfg, top, h, split, s), aux
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
    if isinstance(params, ShardedParams):
        split = seq_split(cfg, params, "prefill", s)
        top = _top(params, cfg)
        h = _embed_tp(params, cfg, top, inputs, split)
        h, cache, _ = trunk(params, cfg, h, positions, mode="prefill",
                            cache=cache)
        if last_only and split:       # the last row is the last rank's
            h = comm.all_gather_cat(h[:, -1:], params.model_group,
                                    1)[:, -1:]
        elif last_only:
            h = h[:, -1:]
        else:
            return _unembed_tp(params, cfg, top, h, split, s), cache
        return _unembed_tp(params, cfg, top, h), cache
    h = embed(params, cfg, inputs)
    h, cache, _ = trunk(params, cfg, h, positions, mode="prefill",
                        cache=cache, remat=False)
    if last_only:
        h = h[:, -1:]
    return unembed(params, cfg, h), cache


def cache_index(cfg: ArchConfig, cache):
    """The tokens written so far: the first layer's device int32 index
    (the same in every layer; a hybrid's from its first period group)."""
    if isinstance(cache, ShardedCache):
        cache = cache.local
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
    if isinstance(params, ShardedParams):
        top = _top(params, cfg)
        h = _embed_tp(params, cfg, top, token, False)
        h, cache, _ = trunk(params, cfg, h, positions, mode="decode",
                            cache=cache)
        return _unembed_tp(params, cfg, top, h), cache
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


def _lm_loss_tp(tp: ShardedParams, cfg: ArchConfig, batch):
    """The loss on a rank's blocks and data shard: vocab-parallel cross
    entropy over ``model`` of more than one rank — the logits' max
    all-reduced (no gradient: the shift cancels), then the sum of
    exponentials and the gold logit in one all-reduce — averaged over the
    data axes (the global batch's mean: each rank's gradient is 1/data of
    its rows').  At one model rank the host's batch-chunked cross entropy
    on the same tensors; with a whole head (the vocab does not divide
    ``model``) each rank's rows, summed over ``model`` under a split."""
    inputs, labels = batch["inputs"], batch["labels"]
    b, s = inputs.shape[:2]
    split = seq_split(cfg, tp, "train", s)
    rows = _rows(tp, split, s)
    top = _top(tp, cfg)
    h = _embed_tp(tp, cfg, top, inputs, split)
    h, _, aux = trunk(tp, cfg, h, default_positions(cfg, b, s,
                                                    inputs.device),
                      mode="train")
    w, softcap = head_weight(top, cfg), cfg.logit_softcap
    if not tp.sharded(_head(cfg)):   # each rank's rows
        nll = _xent_sum(h, w, rows.own_rows(labels), softcap)
        if split:
            nll = comm.sum_replicated(nll, tp.model_group)
        nll = nll / (b * s)
    elif tp.model_size == 1:
        nll = _chunked_xent(rows.rows_in(h, _head(cfg)), w, labels, softcap)
    else:
        logits = (rows.rows_in(h, _head(cfg)) @ w).float()
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        v = logits.shape[-1]
        ids = labels.long() - tp.model_rank * v
        top_ = comm.all_reduce_max(logits.detach().amax(dim=-1),
                                   tp.model_group)
        hit = (ids >= 0) & (ids < v)
        gold = torch.where(hit, logits.gather(
            -1, ids.clamp(0, v - 1)[..., None])[..., 0], 0.0)
        sums = comm.sum_replicated(torch.stack([
            torch.exp(logits - top_[..., None]).sum(dim=-1), gold]),
            tp.model_group)
        nll = (torch.log(sums[0]) + top_ - sums[1]).sum() / (b * s)
    group = tp.data_group()
    if group is not None and comm.group_size(group) > 1:
        nll = comm.sum_replicated(nll, group) / comm.group_size(group)
    if cfg.is_moe:
        nll = nll + 0.01 * aux / cfg.num_layers
    return nll


def lm_loss(params, cfg: ArchConfig, batch):
    """batch: {"inputs": (B,S) ids or (B,S,d) embeds, "labels": (B,S)}.
    On a rank's ``ShardedParams``: :func:`_lm_loss_tp`."""
    if isinstance(params, ShardedParams):
        return _lm_loss_tp(params, cfg, batch)
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
