"""Serving entry point: batched ParaTAA diffusion sampling on one device (the
paper's workload).

Each request is (class label, seed).  Requests run through one
``SamplingEngine`` per (arch, T, solver) configuration, ``--batch-size``
requests per dispatch; sequential DDIM/DDPM is the same engine with the
"seq" spec.  Runs on CUDA unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --requests 4 \
        --steps-T 12 --solver taa --batch-size 2 --device cpu

``--ckpt DIR`` serves the latest checkpoint in DIR (written by
``repro_torch.launch.train --ckpt-dir DIR`` or by the JAX package's
driver) instead of random weights, on either path.

``--serve-async`` serves a simulated stream through ``repro_torch.serving``
instead: a Poisson (``--arrival-rate``) or closed-loop (rate 0) stream over
mixed (T, solver) ``EngineKey``s goes to a ``RequestQueue``, an
``EngineRegistry`` builds one engine per key (warmed ahead of traffic),
and a ``ServingLoop`` on a background thread serves it, reporting p50/p95
latency, throughput and per-key utilization.  ``--chunk-iters K`` switches
to iteration-level continuous batching (a live ``LaneBank`` per key, K
solver iterations a round, lanes retiring at their own convergence or
per-request ``tau``/``quality_steps`` budget and refilled mid-solve);
``--refine`` adds two-tier draft-and-refine, ``--cache`` the Sec 4.2
warm-start cache, ``--trace-out`` a Chrome-trace JSON
(``tools/obs_report.py`` reads it):

    PYTHONPATH=src python -m repro_torch.launch.serve --serve-async --smoke \
        --device cpu --requests 6 --steps-T 8 --chunk-iters 2 \
        --batch-size 2 --loose-tau-frac 0.5 --refine --cache \
        --trace-out trace.json
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.core import ddim_coeffs, ddpm_coeffs
from repro_torch.device import resolve_device
from repro_torch.diffusion.convert import dit_init
from repro_torch.diffusion.dit import dit_apply
from repro_torch.obs import Observability
from repro_torch.runtime import StragglerMitigator
from repro_torch.sampling import SampleRequest, SamplingEngine, get_sampler
from repro_torch.serving import (Batcher, BatchingPolicy, EngineKey,
                                 EngineRegistry, RefinePlanner, RefinePolicy,
                                 RequestQueue, ServingLoop)


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
    Returns (stacked x0 latents, per-request stats, straggler mitigator).
    """
    requests = [r if isinstance(r, SampleRequest) else SampleRequest(*r)
                for r in requests]
    straggler = StragglerMitigator()
    results = engine.run_batch(requests, batch_size=batch_size)
    for dispatch in engine.last_dispatches:  # one latency sample a dispatch
        straggler.record(dispatch["wall_s"])
    stats = [{"label": res.request.label, "iters": res.iters, "nfe": res.nfe,
              "wall_s": res.wall_s} for res in results]
    return np.stack([res.x0 for res in results]), stats, straggler


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


def make_engine_factory(cfg, params, args, device, *, num_tokens=16):
    """EngineKey -> SamplingEngine factory: one shared denoiser and device,
    per-key step count and solver (the registry caches the instances)."""
    def factory(key: EngineKey):
        return make_engine(params, cfg, resolve_coeffs(args, key.T),
                           resolve_spec(args, key.solver),
                           num_tokens=num_tokens, device=device)
    return factory


def mixed_engine_keys(args):
    """The (arch, T, solver) key set the async simulator routes over: the
    CLI configuration itself, a half-depth variant, and an alternate
    solver — ``--mixed-keys N`` keeps the first N."""
    base = EngineKey(args.arch, args.steps_T, args.solver)
    alt_solver = "fp" if args.solver != "fp" else "taa"
    variants = [base,
                EngineKey(args.arch, max(args.steps_T // 2, 4), args.solver),
                EngineKey(args.arch, args.steps_T, alt_solver)]
    # tiny --steps-T makes the half-depth variant collide with base
    return list(dict.fromkeys(variants))[:max(args.mixed_keys, 1)]


def simulate_arrivals(rng, n: int, rate_hz: float):
    """Poisson inter-arrival gaps in seconds (all zero when ``rate_hz`` is 0:
    a closed-loop burst)."""
    if rate_hz <= 0:
        return np.zeros(n)
    return rng.exponential(1.0 / rate_hz, size=n)


def simulated_request(rng, cfg, args, *,
                      allow_overrides: bool = True) -> SampleRequest:
    """One simulated request; with ``--loose-tau-frac`` a fraction of the
    traffic carries per-request early-exit budgets (looser tau and/or a
    Sec 4.1 quality-steps cap).  ``allow_overrides`` is False for
    seq-routed requests (no solver iterations to budget)."""
    kw = {}
    if args.loose_tau_frac and rng.random() < args.loose_tau_frac \
            and allow_overrides:
        kw["tau"] = args.loose_tau
        if args.quality_steps:
            kw["quality_steps"] = args.quality_steps
    return SampleRequest(label=int(rng.integers(0, cfg.num_classes)),
                         seed=int(rng.integers(1 << 30)), **kw)


def serve_async(args, cfg, params, device):
    """Drive the ``repro_torch.serving`` stack with a simulated request
    stream; returns (stacked x0 latents, per-request stats)."""
    keys = mixed_engine_keys(args)
    registry = EngineRegistry(make_engine_factory(cfg, params, args, device))
    policy = BatchingPolicy(max_batch=args.batch_size or 8,
                            max_wait_s=args.max_wait_ms / 1e3)
    # ONE observability bundle spans queue + loop + registry (engines,
    # caches): --trace-out turns on span tracing + convergence curves;
    # metrics mirror either way
    obs = Observability.enabled() if args.trace_out else Observability()
    refiner = None
    if args.refine:
        if not args.chunk_iters:
            raise SystemExit("--refine requires --chunk-iters > 0 "
                             "(refinement splices into live stepwise lanes)")
        refiner = RefinePlanner(RefinePolicy(), metrics=obs.metrics)
    # --cache wires the queue's submit-time hooks: warm-start
    # auto-population from the per-key trajectory cache, plus warm-start
    # shape/dtype validation so a bad init fails its one ticket at submit
    queue = RequestQueue(
        validate=registry.validate_submit if args.cache else None,
        warm_start=registry.warm_start_for if args.cache else None,
        obs=obs)
    loop = ServingLoop(registry, queue, Batcher(policy, metrics=obs.metrics),
                       depth=args.async_depth, chunk_iters=args.chunk_iters,
                       refiner=refiner, cache=args.cache, obs=obs)
    for key in keys:  # first solves ahead of traffic: p95 is not a warmup
        engine = registry.get(key)
        registry.warmup(key, slots=loop.batcher.slots_for(engine),
                        chunk_iters=args.chunk_iters)
        print(f"warmed {key.describe()}: {engine.device}")

    rng = np.random.default_rng(args.seed)
    gaps = simulate_arrivals(rng, args.requests, args.arrival_rate)
    tickets = []
    loop.start()
    try:
        for gap in gaps:
            if gap:
                time.sleep(float(gap))
            key = keys[int(rng.integers(len(keys)))]
            tickets.append(loop.queue.submit(
                simulated_request(rng, cfg, args,
                                  allow_overrides=key.solver != "seq"),
                key))
        results = [t.result(timeout=600) for t in tickets]
    finally:
        loop.stop()

    latencies = np.asarray([t.latency_s for t in tickets])
    span = max(t.completed_time for t in tickets) \
        - min(t.request.arrival_time for t in tickets)
    stats = []
    for ticket, res in zip(tickets, results):
        stats.append({"key": ticket.key.describe(), "label": res.request.label,
                      "iters": res.iters, "nfe": res.nfe,
                      "early_stopped": res.early_stopped,
                      "latency_s": ticket.latency_s,
                      "draft_latency_s": ticket.draft_latency_s,
                      "refines": ticket.refines})
        early = " early-exit" if res.early_stopped else ""
        two_tier = (f" draft@{ticket.draft_latency_s:.2f}s"
                    if ticket.refines else "")
        print(f"{ticket.key.describe():>24s} label={res.request.label:4d} "
              f"iters={res.iters:3d} latency={ticket.latency_s:.2f}s"
              f"{early}{two_tier}")
    if args.chunk_iters:
        for key, report in sorted(loop.bank_reports().items()):
            rounds = max(report["blocking_polls"], 1)  # one poll per round
            print(f"{key.describe()}: {report['completed']} served over "
                  f"{report['refills']} refill(s), device iters "
                  f"{report['device_iters']} x {report['slots']} lanes, "
                  f"wasted lane-iters {report['wasted_iter_frac']:.0%}, "
                  f"device NFE {report['device_nfe']}; host protocol "
                  f"{report['host_fetch_bytes'] / rounds:.0f} B/round "
                  f"over {rounds} round(s), {report['gather_launches']} "
                  f"retired-lane gather(s), "
                  f"{report['update_launches'] / rounds:.1f} update "
                  f"launch(es)/round")
    else:
        for key, engine in sorted(registry.engines().items()):
            observed = loop.batcher.observed(key) or {}
            print(f"{key.describe()}: {engine.stats['batches']} dispatch(es), "
                  f"slot util {observed.get('slot_utilization', 0):.0%}, "
                  f"mean wall {observed.get('wall_s', 0):.2f}s "
                  f"(pack {observed.get('pack_s', 0) * 1e3:.0f}ms)")
    n_early = sum(1 for r in results if r.early_stopped)
    print(f"async served {len(tickets)} requests over {len(keys)} key(s) in "
          f"{span:.2f}s => {len(tickets) / max(span, 1e-9):.2f} req/s; "
          f"latency p50 {np.percentile(latencies, 50):.2f}s "
          f"p95 {np.percentile(latencies, 95):.2f}s; "
          f"mean NFE/request {np.mean([r.nfe for r in results]):.0f}; "
          f"{n_early} early-exit(s); loop stats {loop.stats}")
    if args.refine:
        two_tier = [t for t in tickets if t.refines]
        unresolved = [t for t in tickets
                      if not (t.done() and t.draft_done())]
        if unresolved:
            raise SystemExit(
                f"{len(unresolved)} ticket(s) missing a resolved stage")
        draft_lat = np.asarray([t.draft_latency_s for t in tickets])
        print(f"refine tier: {len(two_tier)} two-tier ticket(s), every "
              f"stage resolved; draft latency p50 "
              f"{np.percentile(draft_lat, 50):.2f}s p95 "
              f"{np.percentile(draft_lat, 95):.2f}s; "
              f"{loop.stats['preemptions']} preemption(s)")
    if args.cache:
        for key in keys:
            c = registry.cache(key).stats()
            total = max(c["hits"] + c["misses"], 1)
            print(f"{key.describe()} cache: {c['hits']}/{total} hits "
                  f"({c['hits'] / total:.0%}), {c['evictions']} "
                  f"eviction(s), {c['entries']} entries "
                  f"({c['bytes']} B)")
    if args.trace_out:
        path = obs.tracer.export(args.trace_out)
        curves = sum(1 for t in tickets if t.residual_curve)
        wait = obs.metrics.histogram("loop.queue_wait_s").merged() \
            or {"p50": 0.0, "p95": 0.0}
        print(f"trace: {len(obs.tracer.events())} event(s) -> {path} "
              f"({obs.tracer.dropped} dropped); residual curves on "
              f"{curves}/{len(tickets)} ticket(s); queue wait "
              f"p50 {wait['p50'] * 1e3:.1f}ms p95 {wait['p95'] * 1e3:.1f}ms")
    return np.stack([res.x0 for res in results]), stats


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
                   help="requests per engine dispatch (0 = all in one "
                        "batch; with --serve-async, 0 = 8-slot batches)")
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
    p.add_argument("--serve-async", action="store_true",
                   help="serve a simulated request stream through the "
                        "repro_torch.serving continuous-batching layer "
                        "instead of one blocking run_batch call")
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="Poisson arrival rate in requests/s for "
                        "--serve-async (0 = closed-loop burst)")
    p.add_argument("--max-wait-ms", type=float, default=50.0,
                   help="batching deadline: max time a request may wait "
                        "for its dispatch to fill (--serve-async)")
    p.add_argument("--async-depth", type=int, default=2,
                   help="whole-batch dispatches kept in flight by the "
                        "serving loop")
    p.add_argument("--mixed-keys", type=int, default=2,
                   help="number of distinct (T, solver) EngineKeys the "
                        "--serve-async simulator routes over")
    p.add_argument("--chunk-iters", type=int, default=0,
                   help="solver iterations per serving round: > 0 switches "
                        "--serve-async to iteration-level continuous "
                        "batching (lanes retire the moment their own "
                        "request converges or early-exits, freed lanes "
                        "refill mid-solve); 0 = whole-batch dispatches")
    p.add_argument("--loose-tau-frac", type=float, default=0.0,
                   help="fraction of simulated requests carrying a looser "
                        "per-request tau (mixed-tau traffic)")
    p.add_argument("--loose-tau", type=float, default=1e-2,
                   help="the looser per-request stopping tolerance for "
                        "--loose-tau-frac traffic")
    p.add_argument("--quality-steps", type=int, default=0,
                   help="per-request quality-steps budget (Sec 4.1 early "
                        "exit) attached to --loose-tau-frac traffic "
                        "(0 = tolerance-only)")
    p.add_argument("--refine", action="store_true",
                   help="two-tier draft-and-refine serving (requires "
                        "--chunk-iters): early-exited drafts resolve their "
                        "ticket's draft stage at once and a warm-started "
                        "preemptible continuation completes the same "
                        "ticket at full tolerance")
    p.add_argument("--cache", action="store_true",
                   help="per-key Sec 4.2 warm-start trajectory cache: "
                        "record converged results, fill SampleRequest.init "
                        "at submit time (with submit-time validation)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Chrome-trace JSON of the --serve-async "
                        "run: per-ticket span chains, engine spans and "
                        "per-lane residual curves (tools/obs_report.py)")
    p.add_argument("--ckpt", default=None,
                   help="trained DiT checkpoint dir (repro_torch.launch."
                        "train --ckpt-dir, or the JAX package's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cpu for a host run)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = dit_init(cfg, args.seed, device)
    if args.ckpt:
        _, tree = CheckpointManager(Path(args.ckpt)).restore(
            {"step": 0, "params": params})
        if tree is not None:
            params = tree["params"]
            print(f"restored checkpoint step {tree['step']}")
    if args.serve_async:
        return serve_async(args, cfg, params, device)

    coeffs = resolve_coeffs(args, args.steps_T)
    engine = make_engine(params, cfg, coeffs, resolve_spec(args, args.solver),
                         device=device)

    rng = np.random.default_rng(args.seed)
    requests = [SampleRequest(label=int(rng.integers(0, cfg.num_classes)),
                              seed=int(rng.integers(1 << 30)))
                for _ in range(args.requests)]
    outs, stats, straggler = serve_batch(engine, requests,
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
          f"=> {seq_steps / mean_iters:.1f}x step reduction; "
          f"p50 deadline {straggler.deadline()}")
    print(f"batched throughput {engine.throughput():.2f} req/s "
          f"({engine.stats['requests']} requests / "
          f"{engine.stats['batches']} batches)")
    return outs, stats


if __name__ == "__main__":
    main()
