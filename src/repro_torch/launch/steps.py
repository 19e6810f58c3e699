"""The step functions of the drivers (train / prefill / decode / ParaTAA
serve), as plain functions on trees of tensors, and their inputs and state
as tensors on ``meta`` (shapes and dtypes only, no data) for the dry-run —
the JAX package's ``repro.launch.steps`` (its ``input_specs``,
``abstract_cache`` and ``abstract_model_state``, in the reference's
``PARAM_DTYPE``, each leaf in its own dtype where its spec names one).
On a mesh, the reference's shardings become PartitionSpec entries
(``input_partition``, ``cache_partition``, ``_cache_spec_for``, by its
rules and divisibility) and ``input_specs(mesh=)`` returns the inputs as
``DTensor``s with those placements on the ``DeviceMesh``.
``abstract_model_state(cfg, mesh=)`` gives a rank's blocks of any model
(``ShardedParams.build``, the slicing ``Placement.shard_params`` hands the
tensor-parallel DiT and LM backbones) and ``abstract_cache(mesh=)`` /
:func:`local_cache` a rank's blocks of the cache (a ``ShardedCache`` whose
entries come from :func:`cache_partition`: the forward reads its layout
from the same rules that size it).

A train step updates the params and optimizer state in place (the
counterpart of the reference's donated buffers) and returns its metrics as
0-d device tensors: nothing in it reads a value back to the host.  On a
rank's ``ShardedParams`` it is the step the reference's GSPMD derives on a
(data, model) mesh: the rank's rows of each global microbatch
(:func:`local_batch`), forward and backward on its blocks, the gradient
sync (``ShardedParams.sync_grads``) and AdamW on its blocks with the
mesh's global norm.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import constant, to_device
from repro_torch.diffusion import dit as dit_mod
from repro_torch.diffusion.schedules import make_schedule
from repro_torch.models import backbone
from repro_torch.models.pdefs import (dtensor_placements, leaf_dtype,
                                      map_defs, resolve_axis)
from repro_torch.models.shardctx import ShardedCache, ShardedParams
from repro_torch.optim import AdamWConfig, adamw_update, lr_schedule
from repro_torch.tree import flatten_with_paths, leaves, map_tree, unflatten

#: the params' dtype of the dry-run's cells (the reference's PARAM_DTYPE)
PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")


def make_loss_fn(cfg: ArchConfig):
    """(params, batch) -> scalar loss: the DiT's denoising loss, or the
    LM backbones' next-token cross entropy (``backbone.lm_loss``, with
    the MoE load-balancing term for MoE configs)."""
    if not cfg.is_diffusion:
        def loss_fn(params, batch):
            return backbone.lm_loss(params, cfg, batch)
        return loss_fn

    def loss_fn(params, batch):
        device = batch["latents"].device
        abar = constant(("abar_linear_1000", device), lambda: to_device(
            make_schedule("linear", 1000)[0], torch.float32, device))
        return dit_mod.dit_loss(params, cfg, batch, abar)
    return loss_fn


def make_grads_fn(cfg: ArchConfig, grad_accum: int = 1):
    """(params, batch) -> (mean loss, mean float32 grads) over
    ``grad_accum`` microbatches of the batch, summed in microbatch order as
    the reference's accumulation scan sums them.  On a rank's
    ``ShardedParams``: ``batch`` is the rank's rows of each microbatch in
    turn (:func:`local_batch`), the loss the global batch's, and the grads
    those of the rank's blocks, synced over the mesh
    (``ShardedParams.sync_grads``)."""
    loss_fn = make_loss_fn(cfg)

    def grads_of(params, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{grad_accum} microbatches")
        tp = params if isinstance(params, ShardedParams) else None
        flat = leaves(tp.local if tp is not None else params)
        for p in flat:
            p.requires_grad_(True)
        try:
            loss, grads = None, None
            micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
            for i in range(grad_accum):
                l = loss_fn(params, {k: v[i] for k, v in micro.items()})
                # a leaf the loss does not reach (the embedding table of
                # a frontend="embed" arch) gets zeros, as jax.grad gives
                g = torch.autograd.grad(l, flat, allow_unused=True,
                                        materialize_grads=True)
                with torch.no_grad():
                    loss = l.detach().to(torch.float32) if loss is None \
                        else loss + l.detach()
                    grads = accumulate_grads(grads, g)
        finally:
            for p in flat:
                p.requires_grad_(False)
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            loss = loss * inv
            for acc in grads:
                acc.mul_(inv)
        if tp is None:
            return loss, unflatten(params, grads)
        tp.sync_grads(grads, partial_leaves(
            cfg, tp, 0 if cfg.is_diffusion else batch["inputs"].shape[1]))
        return loss, unflatten(tp.local, grads)

    return grads_of


def partial_leaves(cfg: ArchConfig, tp: ShardedParams, s: int) -> set:
    """The paths of a rank's blocks whose gradients are partial over
    ``model`` in a train step on ``s`` tokens: none of the DiT's (its
    whole leaves see whole inputs: ``dit.tp_train_collectives``), an LM's
    ``backbone.partial_leaves``."""
    return set() if cfg.is_diffusion else backbone.partial_leaves(cfg, tp, s)


def accumulate_grads(sums, grads):
    """Adds one microbatch's grads into the float32 sums (``None``: the
    first microbatch's, cast, are the sums)."""
    if sums is None:
        return [x.to(torch.float32) for x in grads]
    for acc, x in zip(sums, grads):
        acc.add_(x)
    return sums


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    total_steps: int = 10_000, grad_accum: int = 1):
    """train_step(params, opt_state, batch, step, mark=None) -> (params,
    opt_state, {"loss", "grad_norm", "lr"}).  ``step`` is a 0-d int tensor
    on the device (or an int); ``mark``, when given, is called between the
    backward pass and the optimizer update (where a caller records a CUDA
    event to split the step's device time)."""
    opt_cfg = opt_cfg or AdamWConfig()
    grads_of = make_grads_fn(cfg, grad_accum)

    def train_step(params, opt_state, batch, step, mark=None):
        loss, grads = grads_of(params, batch)
        if mark is not None:
            mark()
        lr = lr_schedule(step, base_lr=opt_cfg.lr, total_steps=total_steps)
        if isinstance(params, ShardedParams):    # the rank's blocks
            _, opt_state, metrics = adamw_update(
                grads, opt_state, params.local, opt_cfg, lr,
                counted=params.norm_counted(), groups=params.norm_groups())
        else:
            params, opt_state, metrics = adamw_update(
                grads, opt_state, params, opt_cfg, lr)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, inputs, cache):
        return backbone.prefill(params, cfg, inputs, cache)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, token, cache):
        return backbone.decode_step(params, cfg, token, cache)
    return decode_step


def make_parataa_serve_step(cfg: ArchConfig, solver_cfg, coeffs):
    """One full ParaTAA sampling run of the DiT over B lanes:
    serve_step(params, xi (B, T+1, N, latent_dim), labels (B,)) -> (x0
    (B, N, latent_dim), iters (B,), nfe (B,))."""
    from repro_torch.core.parataa import sample as parataa_sample

    def serve_step(params, xi, labels):
        def eps_fn(xw, taus_w):     # lane-major: each lane's window rows
            y = labels.repeat_interleave(xw.shape[0] // labels.shape[0])
            return dit_mod.dit_apply(params, cfg, xw, taus_w, y)
        traj, info = parataa_sample(eps_fn, coeffs, solver_cfg, xi)
        return traj[:, 0], info["iters"], info["nfe"]

    return serve_step


# ---------------------------------------------------------------------------
# Inputs and state on meta (the dry-run's; any device the caller names)
# ---------------------------------------------------------------------------


def _inputs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """name -> (shape, dtype) of the cell's model inputs."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_diffusion:
        n, ld = 256, cfg.latent_dim
        return {"latents": ((b, n, ld), PARAM_DTYPE),
                "labels": ((b,), torch.int32),
                "noise": ((b, n, ld), PARAM_DTYPE),
                "t": ((b,), torch.int32)}
    embeds = cfg.frontend == "embed"
    if shape.kind in ("train", "prefill"):
        inputs = ((b, s, cfg.d_model), PARAM_DTYPE) if embeds \
            else ((b, s), torch.int32)
        if shape.kind == "train":
            return {"inputs": inputs, "labels": ((b, s), torch.int32)}
        return {"inputs": inputs}
    return {"token": ((b, 1, cfg.d_model), PARAM_DTYPE) if embeds
            else ((b, 1), torch.int32)}


def input_partition(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """name -> PartitionSpec entries of each input on ``mesh``: the batch
    dim over the data-parallel axes (the "embed" rule's fsdp axes, with
    its divisibility fallback), every other dim replicated.  A train step
    of several microbatches takes instead each microbatch's rows so split
    (:func:`local_batch`)."""
    ba = batch_entry(shape.global_batch, mesh)
    return {k: (ba,) + (None,) * (len(shp) - 1)
            for k, (shp, _) in _inputs(cfg, shape).items()}


def batch_entry(rows: int, mesh, grad_accum: int = 1):
    """The data axes (a PartitionSpec entry) each of ``grad_accum``
    microbatches of a batch of ``rows`` splits over: the "embed" rule's
    fsdp axes that divide a microbatch (the reference reshapes the batch
    to (ga, B / ga) and shards the rows), None where none does."""
    return resolve_axis("embed", rows // grad_accum, mesh)


def local_batch(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """A global train batch (name -> (B, ...) tensors, the same on every
    rank) -> this rank's rows of each of ``grad_accum`` microbatches
    (global rows [i B/ga, (i+1) B/ga), the reference's), microbatch by
    microbatch: its block over :func:`batch_entry`'s axes, or the whole
    microbatch where none divides it.  What ``make_train_step`` on a
    rank's ``ShardedParams`` takes."""
    from repro_torch.models.pdefs import entry_index, entry_size

    rows = next(iter(batch.values())).shape[0]
    if rows % grad_accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{grad_accum} microbatches")
    mb = rows // grad_accum
    entry = batch_entry(rows, mesh, grad_accum)
    n = mb // entry_size(entry, mesh)
    lo = entry_index(entry, mesh) * n
    idx = torch.cat([torch.arange(i * mb + lo, i * mb + lo + n)
                     for i in range(grad_accum)])
    return {k: v.index_select(0, idx.to(v.device)) for k, v in
            batch.items()}


def _sharded_zeros(shp, dtype, device, mesh, spec):
    """A DTensor of global shape ``shp`` with ``spec``'s placements on
    ``mesh``, this rank's block zeros on ``device``."""
    from torch.distributed.tensor import DTensor

    local = list(shp)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            local[dim] //= int(sizes[axis])
    block = torch.zeros(local, dtype=dtype, device=device)
    stride = torch.empty(shp, device=META).stride()
    return DTensor.from_local(block, mesh, dtensor_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shp),
                              stride=stride)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, device=META,
                mesh=None):
    """The model inputs of this (arch, shape) cell as zeros on ``device``:
    a DiT training batch of 256 latent tokens, token ids (float embeds for
    a stub frontend) for train and prefill, one token for decode.  With a
    ``DeviceMesh``, each is a ``DTensor`` placed as :func:`input_partition`
    says (this rank's block of zeros)."""
    inputs = _inputs(cfg, shape)
    if mesh is None:
        return {k: torch.zeros(shp, dtype=dt, device=device)
                for k, (shp, dt) in inputs.items()}
    specs = input_partition(cfg, shape, mesh)
    return {k: _sharded_zeros(shp, dt, device, mesh, specs[k])
            for k, (shp, dt) in inputs.items()}


def _cache_spec_for(path_str: str, shape, mesh) -> tuple:
    """PartitionSpec entries for a cache leaf, by name and divisibility
    (the reference's rules)."""
    def ax(logical, dim):
        return resolve_axis(logical, dim, mesh)

    if path_str.endswith("index"):
        return ()
    ba = ax("embed", shape[0])  # fsdp axes for the batch dim
    if "conv" in path_str:
        return (ba, None, ax("inner", shape[2]))
    if path_str.endswith("state") and len(shape) == 4:  # mamba (B,H,P,N)
        return (ba, ax("ssm_heads", shape[1]), None, None)
    if path_str.endswith("state"):  # rg-lru (B, d)
        return (ba, ax("inner", shape[1]))
    if path_str.endswith("k") or path_str.endswith("v"):  # attn (B,C,KV,D)
        kv_ax = ax("kv_heads", shape[2])
        if kv_ax is not None:
            return (ba, None, kv_ax, None)
        # context-parallel fallback: shard the sequence dim of the cache
        return (ba, ax("heads", shape[1]), None, None)
    if path_str.endswith("scale"):  # int8 kv scales (B, C, KV)
        kv_ax = ax("kv_heads", shape[2])
        if kv_ax is not None:
            return (ba, None, kv_ax)
        return (ba, ax("heads", shape[1]), None)
    return (None,) * len(shape)


def cache_partition(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    dtype=PARAM_DTYPE) -> list:
    """(path, PartitionSpec entries) of every leaf of the cell's cache on
    ``mesh``: stacked caches (homogeneous layers, a hybrid's period
    groups) keep their leading stack dim replicated."""
    out = []
    cache = abstract_cache(cfg, shape, dtype=dtype)
    for path, leaf in flatten_with_paths(cache):
        pstr = "/".join(map(str, path))
        shp = tuple(leaf.shape)
        stacked = (not cfg.is_hybrid) or ("periods" in pstr)
        if "index" in pstr:
            spec = (None,) * len(shp)
        elif stacked:
            spec = (None,) + _cache_spec_for(pstr, shp[1:], mesh)
        else:
            spec = _cache_spec_for(pstr, shp, mesh)
        out.append((path, spec))
    return out


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig, device=META,
                   dtype=PARAM_DTYPE, mesh=None):
    """The decode/prefill cache of the cell (``backbone.init_cache``) on
    ``device``; on a ``DeviceMesh``, this rank's blocks of it
    (:func:`local_cache`)."""
    if mesh is not None:
        return local_cache(cfg, shape.global_batch, shape.seq_len, mesh,
                           dtype, device)
    return backbone.init_cache(cfg, shape.global_batch, shape.seq_len,
                               dtype, device)


def local_cache(cfg: ArchConfig, batch: int, max_seq: int, mesh,
                dtype=torch.bfloat16, device=None) -> ShardedCache:
    """This rank's blocks of the cache of ``batch`` sequences of up to
    ``max_seq`` tokens on ``mesh``, zeros on ``device`` (None = cuda):
    each leaf cut as :func:`cache_partition` says (the reference's
    ``_cache_spec_for``), with those entries, which the tensor-parallel
    forward reads."""
    from repro_torch.device import resolve_device

    shape = ShapeConfig("cache", max_seq, batch, "decode")
    whole = backbone.init_cache(cfg, batch, max_seq, dtype, META)
    return ShardedCache.zeros(whole, cache_partition(cfg, shape, mesh,
                                                     dtype),
                              mesh, resolve_device(device))


def abstract_model_state(cfg: ArchConfig, with_opt: bool = True,
                         dtype=PARAM_DTYPE, device=META, mesh=None):
    """(params, optimizer state or None) as empty tensors on ``device``,
    each param leaf in its spec's dtype or ``dtype``; the AdamW state
    float32 (master, mu, nu) and its int32 count.  On a ``DeviceMesh``
    the params are this rank's
    :class:`~repro_torch.models.shardctx.ShardedParams` (the reference's
    specs: heads, kv_heads, mlp, expert, inner, ssm_heads, vocab and the
    DiT's adaLN columns over ``model`` where they divide, embed rows over
    the data axes: what the tensor-parallel forwards run on) and the
    optimizer state matches its blocks."""
    defs = dit_mod.dit_defs(cfg) if cfg.is_diffusion else \
        backbone.build_defs(cfg)
    params = map_defs(lambda _, spec: torch.empty(
        spec.shape, dtype=leaf_dtype(spec, dtype), device=device), defs)
    if mesh is not None:
        params = ShardedParams.build(params, defs, mesh)
    if not with_opt:
        return params, None

    def f32_like(p):
        return torch.empty(p.shape, dtype=torch.float32, device=device)

    local = params.local if mesh is not None else params
    opt = {"master": map_tree(f32_like, local),
           "mu": map_tree(f32_like, local),
           "nu": map_tree(f32_like, local),
           "count": torch.zeros((), dtype=torch.int32, device=device)}
    return params, opt
