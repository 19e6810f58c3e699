"""ParaTAA with an LM backbone as the denoiser (DiffusionWrapper), in the
PyTorch port: trains a reduced wrapper with the port's AdamW, then samples
it with ParaTAA and with sequential DDIM (T=50) and compares the two.

    PYTHONPATH=src python examples/torch_backbone_denoiser.py \\
        --arch qwen3-0.6b --device cpu

    PYTHONPATH=src python examples/torch_backbone_denoiser.py \
        --arch mamba2-1.3b --device cpu

Runs on CUDA unless ``--device cpu``.  Any of the ten LM archs serves as
the denoiser (attention, mamba2, the RG-LRU hybrid, MoE).
"""
import argparse

import torch

from repro_torch.configs.registry import ARCHS, ASSIGNED
from repro_torch.core import ddim_coeffs
from repro_torch.device import resolve_device, to_device
from repro_torch.diffusion import dit
from repro_torch.diffusion.convert import wrapper_init
from repro_torch.diffusion.schedules import make_schedule
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sampling import (draw_noises, get_sampler, run,
                                  sequential_sample)
from repro_torch.tree import leaves, unflatten


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-0.6b",
                   choices=ASSIGNED)
    p.add_argument("--train-steps", type=int, default=60)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu for a host run)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    latent = 8
    params = wrapper_init(cfg, latent, 0, device)
    opt = adamw_init(params)
    abar = to_device(make_schedule("linear", 1000)[0], torch.float32, device)
    ocfg = AdamWConfig(lr=3e-4, weight_decay=0.0)
    gen = torch.Generator(device=device).manual_seed(0)

    def loss_fn(params):
        x0 = torch.randn(8, 16, latent, generator=gen, device=device) * 0.5
        t = torch.randint(0, 1000, (8,), generator=gen, device=device)
        noise = torch.randn(x0.shape, generator=gen, device=device)
        ab = abar[t][:, None, None]
        x_t = torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * noise
        pred = dit.wrapper_apply(params, cfg, x_t, t.float())
        return torch.mean((pred - noise) ** 2)

    print(f"training {args.arch} wrapper-denoiser ...")
    flat = leaves(params)
    for _ in range(args.train_steps):
        for leaf in flat:
            leaf.requires_grad_(True)
        loss = loss_fn(params)
        # leaves the wrapper never reads (the embedding table) get zeros
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        for leaf in flat:
            leaf.requires_grad_(False)
        params, opt, _ = adamw_update(unflatten(params, grads), opt, params,
                                      ocfg)
    print(f"  loss {float(loss.detach()):.4f}")

    coeffs = ddim_coeffs(50)
    xi = draw_noises(5, coeffs, (16, latent), device=device)

    def eps_fn(xw, taus):
        return dit.wrapper_apply(params, cfg, xw, taus)

    with torch.no_grad():
        x_seq = sequential_sample(eps_fn, coeffs, xi)
        res = run(get_sampler("taa"), eps_fn, coeffs, xi)
    err = float(torch.linalg.norm(res.x0 - x_seq)
                / (torch.linalg.norm(x_seq) + 1e-9))
    print(f"{args.arch}: sequential 50 evals -> ParaTAA {res.iters} "
          f"parallel steps, rel err {err:.2e}")
    return res, err


if __name__ == "__main__":
    main()
