"""Sec 5.3 / Fig 5 in the PyTorch port: smooth image variation by
initializing ParaTAA from an existing trajectory of a similar condition —
warm starts are ``init=`` options of ``repro_torch.sampling.run`` (the
port's counterpart of examples/trajectory_variation.py).

Trains a reduced DiT briefly, samples condition P1, then re-samples
condition P2 three ways — cold (noise init), warm with T_init=T, warm
with T_init=0.7 T (50 and 35 at the default T=50) — and reports the
convergence steps and the interpolation path (distance to both
endpoints per iteration).  Every ParaTAA sample must match its
sequential sample within 2e-2 relative.

    PYTHONPATH=src python examples/torch_trajectory_variation.py --device cpu

Runs on CUDA unless ``--device cpu``.
"""
import argparse

import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.core import ddim_coeffs
from repro_torch.data.pipeline import LatentPipeline
from repro_torch.device import resolve_device
from repro_torch.diffusion import dit
from repro_torch.diffusion.convert import dit_init
from repro_torch.launch import steps as S
from repro_torch.optim import adamw_init
from repro_torch.sampling import (WarmStart, draw_noises, get_sampler, run,
                                  sequential_sample)


def rel_err(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train-steps", type=int, default=120)
    p.add_argument("--steps-T", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu for a host run)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ARCHS["dit-xl"].reduced()
    params = dit_init(cfg, 0, device)
    opt = adamw_init(params)
    step = S.make_train_step(cfg)
    pipe = LatentPipeline(num_tokens=16, latent_dim=cfg.latent_dim,
                          num_classes=cfg.num_classes)
    for i in range(args.train_steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in pipe.batch(i, 16).items()}
        params, opt, _ = step(params, opt, batch, torch.tensor(i))

    T = args.steps_T
    coeffs = ddim_coeffs(T)
    xi = draw_noises(11, coeffs, (16, cfg.latent_dim), device=device)

    def eps_for(label):
        def eps_fn(xw, taus):
            y = torch.full((xw.shape[0],), label, dtype=torch.long,
                           device=device)
            return dit.dit_apply(params, cfg, xw, taus, y)
        return eps_fn

    eps1, eps2 = eps_for(2), eps_for(9)
    with torch.no_grad():
        x1 = sequential_sample(eps1, coeffs, xi)
        x2 = sequential_sample(eps2, coeffs, xi)
        print(f"|x1 - x2| = {float(torch.linalg.norm(x1 - x2)):.3f} "
              "(the two conditions' sequential samples)")

        taa = get_sampler("taa", s_max=2 * T)
        res1 = run(taa, eps1, coeffs, xi)
        print(f"P1 sampled in {res1.iters} parallel steps, rel err "
              f"{rel_err(res1.x0, x1):.2e} against sequential")
        assert rel_err(res1.x0, x1) < 2e-2

        steps = {}
        for name, init in [("cold", None),
                           (f"warm T_init={T}", WarmStart(res1.trajectory, T)),
                           (f"warm T_init={T * 7 // 10}",
                            WarmStart(res1.trajectory, T * 7 // 10))]:
            res = run(taa, eps2, coeffs, xi, init=init, diagnostics=True)
            hist = res.diagnostics["x0_history"]
            flat = hist.reshape(hist.shape[0], -1)
            d1 = torch.linalg.norm(flat - x1.reshape(1, -1), dim=1)
            d2 = torch.linalg.norm(flat - x2.reshape(1, -1), dim=1)
            n = res.iters
            path = " ".join(f"({a:.2f},{b:.2f})" for a, b in
                            zip(d1[:min(n, 6)].tolist(),
                                d2[:min(n, 6)].tolist()))
            print(f"{name:16s}: {n:3d} steps; (|.-x1|, |.-x2|) per iter: "
                  f"{path}")
            assert rel_err(res.x0, x2) < 2e-2, (name, rel_err(res.x0, x2))
            steps[name] = n
    return steps


if __name__ == "__main__":
    main()
