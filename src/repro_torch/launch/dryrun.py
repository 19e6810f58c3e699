"""Dry-run: the cost and the peak memory of every (architecture x input
shape) cell, counted on ``meta`` tensors (shapes only, nothing computed,
no card needed) — the JAX package's ``repro.launch.dryrun``.  ``--mesh``:

* ``one`` (the default): one H100, every cell; records say ``"mesh":
  "one-card"``, ``chips`` 1;
* ``single`` / ``multi``: the production meshes as the reference names
  them, ``pod`` (16 x 16 = 256 ranks) and ``multi-pod`` (2 x 16 x 16 =
  512), built in a ``fake`` world (``launch.mesh.fake_mesh``: this
  process is rank 0 and no collective moves data) and counted as rank
  0's program.  The ParaTAA cell runs there through the sharded engine's
  own code path (requests over the data axes, the DiT tensor-parallel over
  ``model``); every LM prefill and decode cell runs the backbone's
  tensor-parallel forward on rank 0's blocks of the params
  (``steps.abstract_model_state(mesh=)``), of the inputs (its data shard)
  and of the cache (``steps.abstract_cache(mesh=)``); every train cell
  (the LMs' and dit-xl's train_4k) runs the tensor-parallel train step on
  rank 0's blocks and optimizer state and its rows of each microbatch
  (``steps.make_train_step`` on a ``ShardedParams``: forward, backward,
  the gradient sync, the mesh's global norm, AdamW).  ``both`` runs
  ``single`` and ``multi`` side by side, each in a process of its own;
  ``--arch`` and ``--shape`` take comma-joined lists.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --parataa --mesh both
    PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun

Each cell runs its step as the drivers run it (``launch.steps``: train =
``grad_accum`` microbatches + AdamW; prefill; one decode step), with the
reference's ``PARAM_DTYPE`` (bf16; the SSM decays, ``lam`` and the MoE
router float32), under :class:`repro_torch.roofline.counter.CostCounter`:

* **memory**: the program's peak of live storage (arguments +
  temporaries; the reference's ``memory_analysis()`` of its rolled
  program) against the card's 80 GB -> ``fits_hbm``; a train step's over
  two of its microbatches (its float32 grad sums live from the second
  on, and the rest repeat it), then its AdamW update;
* **cost**: as the reference assembles it (its XLA counts a loop body at
  zero), from one scan unit (a layer, a hybrid's period group) counted
  standalone at the cell's (micro)batch:
  serve ``const + n_units x unit``; train ``opt + acc + ga x (loss +
  n_units x unit)``, where const and loss are the program (the loss and
  its grads, at one microbatch) at a depth of one unit less that unit,
  opt is the AdamW update and acc the float32 grad accumulation over the
  whole tree.  Eager PyTorch runs every layer and every KV block, so the
  sum is the program's own count (``runconfig.set_unroll_scans`` has no
  reader here): the FLOPs exactly, the bytes but for the backward of the
  layers' ``unbind`` (it stacks their grads) and, for MoE, the aux
  loss's adds between layers (tests/test_torch_dryrun.py).

The DiT cells count the whole program (a Python loop of blocks in both
packages).  The ParaTAA cell costs one solver iteration of DiT-XL at the
reference's geometry.  Bytes are the eager program's, op by op (the
reference's are XLA's after fusion).  The roofline's compute term takes
bf16 products at 989 TFLOP/s and float32 ones at 67 (``compute_s``) or,
with TF32 on, 495 (``compute_s_tf32``).  The collective column is what
the cell's run issued through ``repro_torch.comm``
(``roofline.analysis.collective_bytes``: 0 on one card), priced by the
link each group crosses (``roofline.analysis.link_bytes``: NVLink inside
a node of 8 ranks, the network between nodes) — modeled, not measured.
The reference's ``lower_s``/``compile_s`` are null (nothing is compiled);
``count_s`` is the seconds of the counted runs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Union

import numpy as np
import torch

from repro_torch import comm
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ASSIGNED, get_arch, get_shape
from repro_torch.launch import steps as S
from repro_torch.models import backbone as B
from repro_torch.optim import AdamWConfig, adamw_update, lr_schedule
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.counter import CostCounter
from repro_torch.tree import leaves

META = S.META

#: --mesh label -> (the record's "mesh", the registry mesh; None = one card)
MESHES = {"one": ("one-card", None), "single": ("single", "pod"),
          "multi": ("multi", "multi-pod")}


def _add(a: dict, b: dict, n: float = 1) -> dict:
    return {k: a.get(k, 0) + n * b.get(k, 0) for k in set(a) | set(b)}


@dataclasses.dataclass
class Cost:
    """FLOPs (split by operand dtype), bytes, and the collectives called
    (bytes by kind and by link tier, calls by kind), added and scaled."""
    flops_by_dtype: dict
    bytes: float
    coll: dict = dataclasses.field(default_factory=dict)
    links: dict = dataclasses.field(default_factory=dict)
    calls: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, counter: CostCounter) -> "Cost":
        return cls(dict(counter.flops_by_dtype), float(counter.bytes),
                   RA.collective_bytes(), RA.link_bytes(),
                   {k: v for k, v in comm.counts.items() if v})

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    def __add__(self, other: "Cost") -> "Cost":
        return self._combine(other, 1)

    def __sub__(self, other: "Cost") -> "Cost":
        return self._combine(other, -1)

    def _combine(self, other: "Cost", n: float) -> "Cost":
        return Cost(_add(self.flops_by_dtype, other.flops_by_dtype, n),
                    self.bytes + n * other.bytes,
                    _add(self.coll, other.coll, n),
                    _add(self.links, other.links, n),
                    _add(self.calls, other.calls, n))

    def __mul__(self, n: float) -> "Cost":
        return Cost._combine(Cost({}, 0.0), self, n)


def _counted(fn, *args, **kw) -> Cost:
    """The cost of ``fn(*args, **kw)`` (its output dropped), with the
    collectives it called (``comm``'s counts from zero)."""
    comm.reset()
    with CostCounter() as counter:
        fn(*args, **kw)
    return Cost.of(counter)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _requires_grad(tree, flag: bool):
    for p in leaves(tree):
        if p.is_floating_point():
            p.requires_grad_(flag)
    return [p for p in leaves(tree) if p.is_floating_point()]


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------


def _local_shape(shape: ShapeConfig, mesh, grad_accum: int = 1
                 ) -> ShapeConfig:
    """The cell's shape with this rank's share of the batch (its data
    shard of each of ``grad_accum`` microbatches; the whole batch where
    the data axes do not divide a microbatch)."""
    if mesh is None:
        return shape
    from repro_torch.models.pdefs import entry_size

    parts = entry_size(S.batch_entry(shape.global_batch, mesh, grad_accum),
                       mesh)
    return dataclasses.replace(shape,
                               global_batch=shape.global_batch // parts)


def _program(cfg, shape: ShapeConfig, device=META, microbatches=None,
             mesh=None):
    """(step fn, its arguments) of the cell, as the drivers run it; a train
    step over ``microbatches`` of its microbatches (default: all).  On a
    mesh: rank 0's blocks of the params (and optimizer state), its rows of
    the inputs and its cache blocks."""
    kind = shape.kind
    ga = cfg.train_grad_accum
    if mesh is not None and kind != "train":
        params, _ = S.abstract_model_state(cfg, with_opt=False,
                                           device=device, mesh=mesh)
        inputs = S.input_specs(cfg, _local_shape(shape, mesh), device)
        cache = S.abstract_cache(cfg, shape, device, mesh=mesh)
        if kind == "prefill":
            return S.make_prefill_step(cfg), (params, inputs["inputs"],
                                              cache)
        return S.make_decode_step(cfg), (params, inputs["token"], cache)
    params, opt = S.abstract_model_state(cfg, with_opt=kind == "train",
                                         device=device, mesh=mesh)
    if mesh is not None:        # the rank's rows of every microbatch
        shape = _local_shape(shape, mesh, ga)
    if kind == "train" and microbatches and microbatches < ga:
        shape = dataclasses.replace(
            shape, global_batch=shape.global_batch // ga * microbatches)
        cfg = dataclasses.replace(cfg, train_grad_accum=microbatches)
    inputs = S.input_specs(cfg, shape, device)
    if kind == "train":
        fn = S.make_train_step(cfg, grad_accum=cfg.train_grad_accum)
        step = torch.zeros((), dtype=torch.int32, device=device)
        return fn, (params, opt, inputs, step)
    cache = S.abstract_cache(cfg, shape, device)
    if kind == "prefill":
        return S.make_prefill_step(cfg), (params, inputs["inputs"], cache)
    return S.make_decode_step(cfg), (params, inputs["token"], cache)


def _memory(fn, args, cost: bool = False):
    """The program's live-storage peak on ``meta``: arguments (what is
    live before it runs) + temporaries; with ``cost``, (that, the run's
    :class:`Cost`) — the cost of a program counted whole."""
    comm.reset()
    with CostCounter() as counter:
        arg_bytes = counter.track(
            [getattr(a, "local", a) for a in args])
        out = fn(*args)
        held = counter.live
        new = counter.track(out)     # outputs made outside the counted ops
    peak = counter.peak
    del out
    mem = dict(argument_bytes=arg_bytes, output_bytes=held + new - arg_bytes,
               temp_bytes=peak - arg_bytes, peak_bytes=peak)
    return (mem, Cost.of(counter)) if cost else mem


def _scan_unit(cfg):
    """(kinds of a scan unit, n_units, the unit's apply, the config at a
    depth of one unit): a layer, or a hybrid's period group (its tail
    stays in the rest of the program)."""
    if cfg.is_hybrid:
        kinds, n_units, _ = B.hybrid_layout(cfg)
    else:
        kinds, n_units = cfg.layer_kinds()[:1], cfg.num_layers
    one = dataclasses.replace(
        cfg, num_layers=cfg.num_layers - (n_units - 1) * len(kinds))

    def unit_apply(lp, h, pos, cache, mode):
        if cfg.is_hybrid:
            return B._apply_group(cfg, kinds, lp, h, pos, mode=mode,
                                  cache=cache, causal=True)
        return B._apply_layer(cfg, kinds[0], lp, h, pos, mode=mode,
                              cache=cache, causal=True)
    return kinds, n_units, unit_apply, one


def _unit_tp(cfg, kinds, lp, defs, shape: ShapeConfig, mesh, device):
    """On a mesh: (the unit's apply on rank 0's blocks of a scan unit's
    params and cache — the layer's data-axis gather included —, the
    residual's rows on the rank, the blocks' ``ShardedParams``).  A train
    unit has no cache."""
    from repro_torch.models.shardctx import (LayerTP, ShardedCache,
                                             ShardedParams)
    from repro_torch.tree import flatten_with_paths, path_name

    tp = ShardedParams.build(lp, defs, mesh)
    b, s = shape.global_batch, shape.seq_len
    mode = shape.kind
    whole = {f"l{j}": B._layer_cache(cfg, k, b, s, S.PARAM_DTYPE, META)
             for j, k in enumerate(kinds)} if cfg.is_hybrid else \
        B._layer_cache(cfg, kinds[0], b, s, S.PARAM_DTYPE, META)
    part = [(path, S._cache_spec_for(path_name(path), tuple(x.shape), mesh))
            for path, x in flatten_with_paths(whole)]
    cache = ShardedCache.zeros(whole, part, mesh, device)
    local = cache.local if mode != "train" else None
    s_eff = 1 if mode == "decode" else s
    split = B.seq_split(cfg, tp, mode, s_eff)

    def view(pre):
        own = {k[len(pre):]: e for k, e in cache.specs.items()
               if k.startswith(pre)}
        return LayerTP(tp, pre, own, split, s_eff)

    def apply(h, pos):
        p = tp.gather_tree("", tp.local)
        if cfg.is_hybrid:
            return B._apply_group(cfg, kinds, p, h, pos, mode=mode,
                                  cache=local, causal=True,
                                  tps=[view(f"l{j}/")
                                       for j in range(len(kinds))])
        return B._apply_layer(cfg, kinds[0], p, h, pos, mode=mode,
                              cache=local, causal=True, tp=view(""))
    rows = s_eff // tp.model_size if split else s_eff
    return apply, rows, tp


def _layer_cost(cfg, shape: ShapeConfig, device=META, mesh=None):
    """One scan unit standalone, at the (micro)batch of the cell: for train
    shapes its loss sum(out) and the grads of its params and input, the
    unit recomputed in the backward pass (the trunk's remat); for prefill
    and decode, the unit over its own cache — on a mesh, rank 0's blocks
    of both, tensor-parallel (a train unit recomputed in the backward
    pass with its collectives, ``shardctx.remat_tp``).  Returns (Cost,
    n_units)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.pdefs import leaf_dtype, map_defs

    kinds, n_units, unit_apply, _ = _scan_unit(cfg)
    if cfg.is_hybrid:
        defs = {f"l{j}": B._layer_def(cfg, k) for j, k in enumerate(kinds)}
    else:
        defs = B._layer_def(cfg, kinds[0])
    lp = map_defs(lambda _, spec: torch.empty(
        spec.shape, dtype=leaf_dtype(spec, S.PARAM_DTYPE), device=device),
        defs)
    if mesh is not None:
        apply, rows, tp = _unit_tp(cfg, kinds, lp, defs, shape, mesh,
                                   device)
        ga = cfg.train_grad_accum if shape.kind == "train" else 1
        b = _local_shape(shape, mesh, ga).global_batch // ga
        s_eff = 1 if shape.kind == "decode" else shape.seq_len
        h = torch.zeros((b, rows, cfg.d_model), dtype=S.PARAM_DTYPE,
                        device=device)
        pos = B.default_positions(cfg, b, s_eff, device)
        if shape.kind != "train":
            with torch.no_grad():
                return _counted(apply, h, pos), n_units
        flat = _requires_grad(tp.local, True) + [h.requires_grad_(True)]

        def run_tp():
            out, _ = B.remat_tp(True, apply, h, pos)
            return torch.autograd.grad(out.float().sum(), flat,
                                       allow_unused=True,
                                       materialize_grads=True)
        try:
            return _counted(run_tp), n_units
        finally:
            _requires_grad(tp.local, False)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        b //= cfg.train_grad_accum
    s_eff = 1 if shape.kind == "decode" else s
    h = torch.zeros((b, s_eff, cfg.d_model), dtype=S.PARAM_DTYPE,
                    device=device)
    pos = B.default_positions(cfg, b, s_eff, device)
    if shape.kind == "train":
        flat = _requires_grad(lp, True) + [h.requires_grad_(True)]

        def run():
            out, _ = checkpoint(unit_apply, lp, h, pos, None, "train",
                                use_reentrant=False)
            return torch.autograd.grad(out.float().sum(), flat,
                                       allow_unused=True,
                                       materialize_grads=True)
        try:
            return _counted(run), n_units
        finally:
            _requires_grad(lp, False)

    def layer_cache(kind):
        return B._layer_cache(cfg, kind, b, s, S.PARAM_DTYPE, device)
    cache = {f"l{j}": layer_cache(k) for j, k in enumerate(kinds)} \
        if cfg.is_hybrid else layer_cache(kinds[0])
    with torch.no_grad():
        return _counted(unit_apply, lp, h, pos, cache, shape.kind), n_units


def _loss_cost(cfg, shape: ShapeConfig, device=META, mesh=None):
    """The loss and the grads of every param at one microbatch — as the
    train step takes them — for ``cfg`` as given; on a mesh, rank 0's
    rows and blocks."""
    ga = cfg.train_grad_accum
    local = _local_shape(shape, mesh, ga)
    mb = dataclasses.replace(shape, global_batch=local.global_batch // ga)
    params, _ = S.abstract_model_state(cfg, with_opt=False, device=device,
                                       mesh=mesh)
    tree = params.local if mesh is not None else params
    batch = S.input_specs(cfg, mb, device)
    loss_fn = S.make_loss_fn(cfg)
    flat = _requires_grad(tree, True)
    try:
        cost = _counted(lambda: torch.autograd.grad(
            loss_fn(params, batch), flat, allow_unused=True,
            materialize_grads=True))
    finally:
        _requires_grad(tree, False)
    return cost


def _update_cost(cfg, shape: ShapeConfig, device=META, mesh=None):
    """(AdamW update, float32 grad accumulation over the microbatches),
    each over the whole param tree — on a mesh over rank 0's blocks, the
    update with the gradient sync (``steps.partial_leaves`` of the
    shape's tokens) and the mesh's global norm."""
    params, opt = S.abstract_model_state(cfg, device=device, mesh=mesh)
    tree = params.local if mesh is not None else params
    grads = [torch.empty(p.shape, dtype=p.dtype, device=device)
             for p in leaves(tree)]
    f32 = [g.float() for g in grads]
    step = torch.zeros((), dtype=torch.int32, device=device)
    ocfg = AdamWConfig()
    lr = lr_schedule(step, base_lr=ocfg.lr, total_steps=10_000)
    if mesh is None:
        opt_cost = _counted(lambda: adamw_update(f32, opt, params, ocfg, lr))
    else:
        partial = S.partial_leaves(cfg, params, shape.seq_len)

        def update():
            params.sync_grads(f32, partial)
            adamw_update(f32, opt, tree, ocfg, lr,
                         counted=params.norm_counted(),
                         groups=params.norm_groups())
        opt_cost = _counted(update)
    ga = cfg.train_grad_accum

    def accumulate():
        sums = S.accumulate_grads(None, grads)
        for _ in range(ga - 1):
            S.accumulate_grads(sums, grads)
        if ga > 1:
            for acc in sums:
                acc.mul_(1.0 / ga)
    return opt_cost, _counted(accumulate)


def cell_cost(cfg, shape: ShapeConfig, device=META, mesh=None):
    """(Cost, n_units): the cell's cost assembled from a standalone scan
    unit (module docstring); the DiT's counted whole.  On a mesh: rank
    0's."""
    if cfg.is_diffusion:
        fn, args = _program(cfg, shape, device, mesh=mesh)
        return _counted(fn, *args), 0
    unit, n_units = _layer_cost(cfg, shape, device, mesh)
    _, _, _, one = _scan_unit(cfg)
    if shape.kind == "train":
        loss = _loss_cost(one, shape, device, mesh) - unit
        opt, acc = _update_cost(cfg, shape, device, mesh)
        ga = cfg.train_grad_accum
        return opt + acc + (loss + unit * n_units) * ga, n_units
    fn, args = _program(one, shape, device, mesh=mesh)
    with torch.no_grad():
        const = _counted(fn, *args) - unit
    return const + unit * n_units, n_units


def _roofline(cost: Cost) -> dict:
    """The record's roofline fields, the collective terms from the
    bytes the cell moved by kind (``RA.collective_bytes``) and by the
    link tier each crossed (``RA.link_bytes``)."""
    coll = {k: int(v) for k, v in cost.coll.items()}
    by_link = {k: int(v) for k, v in cost.links.items()}
    coll_bytes = float(sum(coll.values()))
    terms = RA.roofline_terms(cost.flops, cost.bytes, coll_bytes,
                              flops_by_dtype=cost.flops_by_dtype,
                              by_link=by_link)
    tf32 = RA.roofline_terms(cost.flops, cost.bytes, coll_bytes,
                             flops_by_dtype=cost.flops_by_dtype, tf32=True,
                             by_link=by_link)
    return dict(flops_per_chip=cost.flops, bytes_per_chip=cost.bytes,
                flops_by_dtype=cost.flops_by_dtype,
                collective_bytes_per_chip=coll_bytes,
                collective_breakdown={k: v for k, v in coll.items() if v},
                collective_by_link=by_link,
                compute_s=terms.compute_s, compute_s_tf32=tf32.compute_s,
                memory_s=terms.memory_s, collective_s=terms.collective_s,
                dominant=terms.dominant, step_time_lb_s=terms.step_time_lb)


def run_cell(arch_name: str, shape: Union[str, ShapeConfig], *,
             cfg=None, mesh_label: str = "one-card", mesh=None,
             verbose: bool = True) -> dict:
    """One (arch, shape) cell on ``meta``.  ``shape`` is a name of
    ``configs.base.SHAPES`` or a ``ShapeConfig``; ``cfg`` overrides the
    registry's config (a reduced one in the tests).  On a production mesh
    (``mesh_label`` "single" or "multi", ``mesh`` its ``DeviceMesh`` in a
    ``fake`` world) a cell is rank 0's tensor-parallel program
    (:func:`run_mesh_cell`)."""
    cfg = cfg or get_arch(arch_name)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    rec = {"arch": arch_name, "shape": shape.name, "mesh": mesh_label}
    ok, reason = cfg.supports_shape(shape)
    if not ok:
        return {**rec, "status": "skipped", "reason": reason}
    if mesh_label != "one-card":
        if mesh is None:
            raise ValueError(f"mesh {mesh_label!r} needs its DeviceMesh")
        return run_mesh_cell(cfg, shape, mesh, rec, verbose)
    rec.update(chips=1, status="error")
    t0 = time.monotonic()
    comm.reset()
    # the peak of a train step is reached by its second microbatch (the
    # float32 grad sums live from then on): two stand for all of them,
    # with the whole batch's bytes among the arguments
    fn, args = _program(cfg, shape, microbatches=2)
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with grad:
        mem = _memory(fn, args)
    if shape.kind == "train":
        extra = _nbytes(S.input_specs(cfg, shape)) - _nbytes(args[2])
        for key in ("argument_bytes", "peak_bytes"):
            mem[key] += extra
    del fn, args
    cost, n_units = cell_cost(cfg, shape)
    mf = RA.model_flops(cfg, shape)
    rec.update(
        status="ok", lower_s=None, compile_s=None,
        count_s=time.monotonic() - t0, n_units=n_units, **mem,
        fits_hbm=bool(mem["peak_bytes"] < RA.HBM_PER_CHIP),
        **_roofline(cost), model_flops_global=mf,
        model_flops_ratio=mf / cost.flops if cost.flops else None)
    if verbose:
        _print(rec)
    return rec


#: how the production records price their collectives
COLLECTIVE_MODEL = (
    "modeled, not measured: each group's bytes at the slowest link its "
    f"ranks cross, NVLink 4 {RA.LINK_BW / 1e9:g} GB/s each way inside a "
    f"node of {RA.RANKS_PER_NODE} consecutive ranks (HGX H100), one 400 "
    f"Gb/s NDR InfiniBand port a GPU ({RA.NETWORK_BW / 1e9:g} GB/s) "
    "across nodes")


def run_mesh_cell(cfg, shape: ShapeConfig, mesh, rec: dict,
                  verbose: bool = True) -> dict:
    """A cell as rank 0's tensor-parallel program on ``mesh`` (a ``fake``
    world): memory from the whole program on its blocks (a train step's
    over two microbatches, with all its rows among the arguments, as on
    one card), cost (collectives included) from one scan unit and the
    rest as on one card; the DiT's counted whole (module docstring)."""
    from repro_torch.launch.mesh import axis_sizes

    chips = int(np.prod(list(axis_sizes(mesh).values())))
    rec.update(chips=chips, status="error",
               placement=" x ".join(f"{k}={v}" for k, v in
                                    axis_sizes(mesh).items()))
    t0 = time.monotonic()
    train = shape.kind == "train"
    fn, args = _program(cfg, shape, mesh=mesh,
                        microbatches=2 if train else None)
    # the DiT's whole program (one microbatch) counted once for both
    whole = cfg.is_diffusion and cfg.train_grad_accum == 1
    with torch.enable_grad() if train else torch.no_grad():
        mem = _memory(fn, args, cost=whole)
    if whole:
        mem, cost = mem
        n_units = 0
    if train:
        local = _local_shape(shape, mesh, cfg.train_grad_accum)
        extra = _nbytes(S.input_specs(cfg, local)) - _nbytes(args[2])
        for key in ("argument_bytes", "peak_bytes"):
            mem[key] += extra
    del fn, args
    if not whole:
        cost, n_units = cell_cost(cfg, shape, mesh=mesh)
    mf = RA.model_flops(cfg, shape)
    rec.update(
        status="ok", lower_s=None, compile_s=None,
        count_s=time.monotonic() - t0, n_units=n_units, **mem,
        fits_hbm=bool(mem["peak_bytes"] < RA.HBM_PER_CHIP),
        **_roofline(cost),
        collective_counts={k: int(v) for k, v in cost.calls.items() if v},
        model_flops_global=mf,
        model_flops_ratio=mf / (cost.flops * chips) if cost.flops else None,
        collective_model=COLLECTIVE_MODEL)
    if verbose:
        _print(rec)
    return rec


def _print(rec: dict) -> None:
    print(f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: counted in "
          f"{rec['count_s']:.1f}s, compute {rec['compute_s'] * 1e3:.2f}ms "
          f"(TF32 {rec['compute_s_tf32'] * 1e3:.2f}ms) / mem "
          f"{rec['memory_s'] * 1e3:.2f}ms / coll "
          f"{rec['collective_s'] * 1e3:.2f}ms -> {rec['dominant']}-"
          f"bound; peak {rec['peak_bytes'] / 1e9:.2f} GB (fits="
          f"{rec['fits_hbm']}) mf-ratio="
          f"{rec['model_flops_ratio'] and round(rec['model_flops_ratio'], 3)}")


def run_parataa_cell(*, mesh=None, mesh_label: str = "one-card",
                     T: int = 100, window: int = 64, n_samples: int = 16,
                     history_m: int = 3, reduced: bool = False,
                     verbose: bool = True) -> dict:
    """The paper's workload as a cell: ParaTAA sampling of DiT-XL, 16
    requests of 256 latent tokens, T=100, window 64, history 3, order 8
    (the reference's geometry), in float32 as the port serves it (the
    reference's bf16 params meet float32 latents and compute in float32).

    Counted through the serving engine's own code path: a
    ``SamplingEngine`` (``serve.make_engine``) on ``Placement.host()``, or
    with ``mesh`` (a ``DeviceMesh``; the dry-run's are ``fake_mesh``'s) on
    ``Placement.for_mesh(mesh)``: the requests rounded up to the data
    shards, this rank's lanes, its blocks of the DiT
    (``steps.abstract_model_state(mesh=)``: tensor-parallel over
    ``model``, FSDP over the data axes) — rank 0's program, the same on
    every rank up to its coordinates.  The TAA round runs on each data
    shard's lanes, replicated over ``model``.

    Memory: the solver state (the rank's lanes) and the params, through
    one guarded iteration — every iteration of the loop is that program.
    Cost: one guarded solver iteration (the window's DiT forwards, the
    residuals, the TAA round and the per-lane selects; the round on
    ``meta`` is its plain version) and, on a mesh, the poll's flag
    all-reduce: x the iteration count for a request's cost.  ``reduced``:
    the reduced DiT at 32 tokens."""
    from repro_torch.core import ddim_coeffs
    from repro_torch.core import parataa
    from repro_torch.launch.serve import make_engine
    from repro_torch.sampling import Placement, get_sampler

    cfg = get_arch("dit-xl")
    if reduced:
        cfg = cfg.reduced()
    n_tok = 32 if reduced else 256
    placement = Placement.host() if mesh is None else \
        Placement.for_mesh(mesh)
    n_samples = placement.round_batch(n_samples)
    chips = placement.num_devices
    rec = {"arch": "dit-xl", "shape": "parataa_serve", "mesh": mesh_label,
           "chips": chips, "status": "error", "T": T, "window": window,
           "n_samples": n_samples,
           "placement": "one device" if mesh is None
           else placement.describe(denoiser_sharded=True)}
    t0 = time.monotonic()
    coeffs = ddim_coeffs(T)
    spec = get_sampler("taa", order_k=8, history_m=history_m, window=window,
                       s_max=2 * T)
    params, _ = S.abstract_model_state(cfg, with_opt=False,
                                       dtype=torch.float32, mesh=mesh)
    engine = make_engine(params, cfg, coeffs, spec, num_tokens=n_tok,
                         device=META, placement=placement)
    lo, hi = placement.lanes(n_samples)
    solver = engine._solver_cfg(spec.solver_config(T))
    labels = torch.zeros((hi - lo,), dtype=torch.long, device=META)
    xi = torch.empty((hi - lo, T + 1, n_tok, cfg.latent_dim),
                     dtype=torch.float32, device=META)
    state = parataa.init_state(coeffs, solver, xi)
    static = parataa._build_static(coeffs, solver, META)
    eps_flat = parataa._flat_eps(engine._lane_eps(labels),
                                 (n_tok, cfg.latent_dim))
    comm.reset()
    with torch.no_grad(), placement.activations(), \
            CostCounter() as counter:
        arg_bytes = counter.track(getattr(engine.params, "local",
                                          engine.params), state, labels)
        nxt = parataa._guarded_step(state, static, solver, eps_flat)
        if mesh is not None:        # the poll's flag, over the data shards
            comm.all_reduce_min(nxt.finished.all().to(torch.int32),
                                placement.data_group)
        del nxt
    cost = Cost.of(counter)
    peak = counter.peak
    mf = 2.0 * cfg.param_count() * n_samples * window * n_tok
    rec.update(
        status="ok", compile_s=None, count_s=time.monotonic() - t0,
        argument_bytes=arg_bytes, temp_bytes=peak - arg_bytes,
        peak_bytes=peak, fits_hbm=bool(peak < RA.HBM_PER_CHIP),
        **_roofline(cost),
        collective_counts={k: v for k, v in comm.counts.items() if v},
        model_flops_global=mf,
        model_flops_ratio=mf / (cost.flops * chips) if cost.flops else None,
        note="per-ITERATION cost; end-to-end = iters x this")
    if mesh is not None:
        rec["collective_model"] = COLLECTIVE_MODEL
    if verbose:
        _print(rec)
    return rec


def _error(arch, shape, e, mesh_label: str = "one-card") -> dict:
    traceback.print_exc()
    return {"arch": arch, "shape": shape, "mesh": mesh_label,
            "status": "error", "error": repr(e)}


def _cells(args) -> list:
    if args.all:
        shapes = args.shape.split(",") if args.shape else list(SHAPES)
        return [(a, s) for a in ASSIGNED for s in shapes] + \
            [("dit-xl", "train_4k")] * ("train_4k" in shapes)
    if args.parataa:
        return []
    if not (args.arch and args.shape):
        raise SystemExit("--arch/--shape, --parataa or --all")
    return [(a, s) for a in args.arch.split(",")
            for s in args.shape.split(",")]


def _run(args, mesh_key: str) -> int:
    """Every asked-for cell on one mesh; returns the failures."""
    label, registry_name = MESHES[mesh_key]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failures = 0

    def write(arch, shape, rec):
        (out / f"{arch}__{shape}__{label}.json").write_text(
            json.dumps(rec, indent=1, default=str))

    with contextlib.ExitStack() as stack:
        mesh = None
        if registry_name is not None:
            from repro_torch.launch.mesh import fake_mesh

            mesh = stack.enter_context(fake_mesh(registry_name))
        for arch_name, shape_name in _cells(args):
            try:
                rec = run_cell(arch_name, shape_name, mesh_label=label,
                               mesh=mesh)
            except Exception as e:  # noqa: BLE001 — the record says why
                rec = _error(arch_name, shape_name, e, label)
                failures += 1
            write(arch_name, shape_name, rec)
        if not (args.all or args.parataa):
            return failures
        try:
            rec = run_parataa_cell(mesh=mesh, mesh_label=label)
        except Exception as e:  # noqa: BLE001
            rec = _error("dit-xl", "parataa_serve", e, label)
            failures += 1
        write("dit-xl", "parataa_serve", rec)
    return failures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None,
                   help="an arch, or several joined by commas")
    p.add_argument("--shape", default=None,
                   help="a shape, or several joined by commas (with "
                        "--all: only those shapes)")
    p.add_argument("--all", action="store_true",
                   help="every assigned cell, dit-xl x train_4k and the "
                        "ParaTAA cell")
    p.add_argument("--parataa", action="store_true",
                   help="only the ParaTAA batched-sampling cell")
    p.add_argument("--mesh", default="one",
                   choices=["one", "single", "multi", "both"],
                   help="one H100 (one), the pod mesh of 256 ranks "
                        "(single), multi-pod of 512 (multi), or single "
                        "then multi, each in its own process (both)")
    p.add_argument("--out", default="build/dryrun")
    args = p.parse_args(argv)

    if args.mesh == "both":
        # one default group a process: each production mesh in its own,
        # the two side by side
        base = list(argv if argv is not None else sys.argv[1:])
        procs = [subprocess.Popen([sys.executable, "-m",
                                   "repro_torch.launch.dryrun", *base,
                                   "--mesh", key])
                 for key in ("single", "multi")]
        failures = sum(p.wait() != 0 for p in procs)
        if failures:
            raise SystemExit(f"{failures} mesh run(s) failed")
        return
    failures = _run(args, args.mesh)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
