"""The step functions of the drivers (train / ParaTAA serve), as plain
functions on trees of tensors — the DiT part of the JAX package's
``repro.launch.steps``.

A train step updates the params and optimizer state in place (the
counterpart of the reference's donated buffers) and returns its metrics as
0-d device tensors: nothing in it reads a value back to the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import constant, to_device
from repro_torch.diffusion import dit as dit_mod
from repro_torch.diffusion.schedules import make_schedule
from repro_torch.optim import AdamWConfig, adamw_update, lr_schedule
from repro_torch.tree import leaves, unflatten


def make_loss_fn(cfg: ArchConfig):
    """(params, batch) -> scalar loss.  Only the DiT is ported: the LM
    backbones' loss waits for them (ROADMAP Queue 1)."""
    if not cfg.is_diffusion:
        raise NotImplementedError(
            f"{cfg.name}: only the DiT's loss is ported; the LM backbones "
            f"are still to port (ROADMAP Queue 1)")

    def loss_fn(params, batch):
        device = batch["latents"].device
        abar = constant(("abar_linear_1000", device), lambda: to_device(
            make_schedule("linear", 1000)[0], torch.float32, device))
        return dit_mod.dit_loss(params, cfg, batch, abar)
    return loss_fn


def make_grads_fn(cfg: ArchConfig, grad_accum: int = 1):
    """(params, batch) -> (mean loss, mean float32 grads) over
    ``grad_accum`` microbatches of the batch, summed in microbatch order as
    the reference's accumulation scan sums them."""
    loss_fn = make_loss_fn(cfg)

    def grads_of(params, batch):
        rows = batch["latents"].shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{grad_accum} microbatches")
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            loss, grads = None, None
            micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
            for i in range(grad_accum):
                l = loss_fn(params, {k: v[i] for k, v in micro.items()})
                g = torch.autograd.grad(l, flat)
                with torch.no_grad():
                    if grads is None:
                        loss = l.detach().to(torch.float32)
                        grads = [x.to(torch.float32) for x in g]
                    else:
                        loss = loss + l.detach()
                        for acc, x in zip(grads, g):
                            acc.add_(x)
        finally:
            for p in flat:
                p.requires_grad_(False)
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            loss = loss * inv
            for acc in grads:
                acc.mul_(inv)
        return loss, unflatten(params, grads)

    return grads_of


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
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg, lr)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


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
