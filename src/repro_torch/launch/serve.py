"""Serving entry point: batched ParaTAA diffusion sampling on one device (the
paper's workload), synchronous path.

Each request is (class label, seed).  Requests run through one
``SamplingEngine`` per (arch, T, solver) configuration, ``--batch-size``
requests per dispatch; sequential DDIM/DDPM is the same engine with the
"seq" spec.  Runs on CUDA unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --requests 4 \
        --steps-T 12 --solver taa --batch-size 2 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.registry import get_arch
from repro_torch.core import ddim_coeffs, ddpm_coeffs
from repro_torch.device import resolve_device
from repro_torch.diffusion.convert import dit_init
from repro_torch.diffusion.dit import dit_apply
from repro_torch.sampling import SampleRequest, SamplingEngine, get_sampler


def make_eps_apply(cfg):
    """Engine-shaped denoiser adapter: (params, x, taus, labels) -> eps."""
    def eps_apply(params, xw, taus_w, labels):
        return dit_apply(params, cfg, xw, taus_w, labels)
    return eps_apply


def make_engine(params, cfg, coeffs, spec, *, num_tokens=16, device=None,
                noise_fn=None) -> SamplingEngine:
    return SamplingEngine(make_eps_apply(cfg), params, coeffs, spec,
                          sample_shape=(num_tokens, cfg.latent_dim),
                          device=device, noise_fn=noise_fn)


def serve_batch(engine: SamplingEngine, requests, *, batch_size=None):
    """Run requests through the engine ``batch_size`` at a time.

    requests: list of SampleRequest, or (label, seed) tuples.
    Returns (stacked x0 latents, per-request stats).
    """
    requests = [r if isinstance(r, SampleRequest) else SampleRequest(*r)
                for r in requests]
    results = engine.run_batch(requests, batch_size=batch_size)
    stats = [{"label": res.request.label, "iters": res.iters, "nfe": res.nfe,
              "wall_s": res.wall_s} for res in results]
    return np.stack([res.x0 for res in results]), stats


def resolve_coeffs(args, T: int):
    """CLI schedule flag -> SolverCoeffs at step count ``T``."""
    return (ddim_coeffs if args.sampler == "ddim" else ddpm_coeffs)(T)


def resolve_spec(args, solver: str):
    """CLI solver flags -> SamplerSpec."""
    if solver == "seq":
        return get_sampler("seq")
    return get_sampler(solver, order_k=args.order_k,
                       history_m=args.history_m, window=args.window,
                       fuse_round=args.fuse_round)


def report_dispatches(engine: SamplingEngine, *, out=print):
    """One line per dispatch of the last ``run_batch``."""
    for i, d in enumerate(engine.last_dispatches):
        out(f"dispatch {i}: {d['requests']}/{d['slots']} request slots "
            f"({d['slot_utilization']:.0%}) on {engine.device}, "
            f"device iters {d['device_iters']}, "
            f"update launches {d['update_launches']}, "
            f"wall {d['wall_s']:.2f}s")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="dit-xl")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=0,
                   help="requests per engine dispatch (0 = all in one batch)")
    p.add_argument("--steps-T", type=int, default=50)
    p.add_argument("--solver", default="taa", choices=["fp", "aa", "taa", "seq"])
    p.add_argument("--sampler", default="ddim", choices=["ddim", "ddpm"])
    p.add_argument("--order-k", type=int, default=8)
    p.add_argument("--history-m", type=int, default=3)
    p.add_argument("--window", type=int, default=0)
    p.add_argument("--fuse-round", action="store_true",
                   help="each Anderson round (Gram + gamma solve + apply) as "
                        "ONE taa_round kernel launch on the card instead of "
                        "the staged Gram -> solve -> apply")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cpu for a host run)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = dit_init(cfg, args.seed, device)

    coeffs = resolve_coeffs(args, args.steps_T)
    engine = make_engine(params, cfg, coeffs, resolve_spec(args, args.solver),
                         device=device)

    rng = np.random.default_rng(args.seed)
    requests = [SampleRequest(label=int(rng.integers(0, cfg.num_classes)),
                              seed=int(rng.integers(1 << 30)))
                for _ in range(args.requests)]
    outs, stats = serve_batch(engine, requests,
                              batch_size=args.batch_size or None)
    for st in stats:
        # wall_s is the wall time of the DISPATCH the request rode in (its
        # latency), not exclusive per-request compute — batch members share it
        print(f"label={st['label']:4d} iters={st['iters']:3d} "
              f"nfe={st['nfe']:5d} batch_wall={st['wall_s']:.2f}s")
    report_dispatches(engine)
    seq_steps = coeffs.T
    mean_iters = np.mean([s["iters"] for s in stats])
    print(f"mean parallel steps {mean_iters:.1f} vs sequential {seq_steps} "
          f"=> {seq_steps / mean_iters:.1f}x step reduction")
    print(f"batched throughput {engine.throughput():.2f} req/s "
          f"({engine.stats['requests']} requests / "
          f"{engine.stats['batches']} batches)")
    return outs, stats


if __name__ == "__main__":
    main()
