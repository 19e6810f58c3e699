"""AdamW as plain functions on trees of tensors, with mixed-precision master
weights — the JAX package's ``repro.optim.adamw`` with the same state
layout and numerics.

Optimizer state (per parameter): f32 master copy + f32 (mu, nu), and the
int32 step ``count``: ``{"master", "mu", "nu", "count"}``, the reference's
layout, so a checkpoint of it crosses between the packages.  Model params
may be bf16 (compute dtype) — updates are applied to the master copy and
cast back.  :func:`adamw_update` updates master, mu, nu and the params in
place (the counterpart of the reference's donated buffers) and reads
nothing back to the host: the clip scale, bias corrections and learning
rate stay 0-d device tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params):
    """State for ``params``: a float32 master copy (a copy also of float32
    params, which the update changes in place), zero moments, count 0."""
    first = leaves(params)[0]
    return {
        "master": map_tree(lambda p: p.detach().to(torch.float32, copy=True),
                           params),
        "mu": map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        "nu": map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree, counted=None, groups=()) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``.  On a mesh, of the tree whose
    blocks the ranks hold: ``counted`` (a bool a leaf) names the blocks
    this rank adds (``ShardedParams.norm_counted``: each element once over
    the mesh), and the sum of squares is all-reduced over each of
    ``groups`` before the root, so every rank clips by the same norm."""
    from repro_torch import comm

    flat = leaves(tree)
    if counted is None:
        counted = [True] * len(flat)
    total = sum(torch.sum(torch.square(x.to(torch.float32)))
                for x, c in zip(flat, counted) if c)
    if not isinstance(total, torch.Tensor):     # this rank counts nothing
        total = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for group in groups:
        total = comm.all_reduce_sum_(total.reshape(1), group)[0]
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig, lr_t=None, *,
                 counted=None, groups=()):
    """Returns (params, opt_state, metrics): params, master, mu and nu
    updated in place, a new ``count``; metrics ``grad_norm`` and ``lr`` as
    0-d float32 tensors on the params' device.  ``counted``/``groups``:
    the global norm over a mesh (:func:`global_norm`); the rest is the
    same on a rank's blocks."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads, counted, groups)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = cfg.lr if lr_t is None else lr_t
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), lr, dtype=torch.float32, device=count.device)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)

    for g, mu, nu, master, p in zip(
            leaves(grads), leaves(opt_state["mu"]), leaves(opt_state["nu"]),
            leaves(opt_state["master"]), leaves(params)):
        g = g.to(torch.float32) * scale
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        step = (mu / c1).div_(torch.sqrt(nu / c2).add_(cfg.eps))
        master.sub_(step.add_(master * cfg.weight_decay).mul_(lr))
        p.copy_(master)
    new_state = {"master": opt_state["master"], "mu": opt_state["mu"],
                 "nu": opt_state["nu"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
