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

``--use-pallas {auto,on,off}`` routes the solver's TAA round: by the
device (auto), through the hand-written kernels (on; a CPU tensor
raises), or through their plain PyTorch versions on any device (off).
``--backend-tune`` turns TF32 on for float32 matmuls and convolutions on
a CUDA device before the first model call (``launch/backend.py``).

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

``--mesh NAME`` (with ``--data-parallel``/``--model-parallel``/
``--time-parallel`` axis overrides) places every engine on a registered
rank mesh (``repro_torch.launch.mesh``): one process per rank under
``torchrun``, NCCL on the card and gloo with ``--device cpu``.  The
request axis shards over ``data``, a ``*-time`` mesh's ``time`` axis
shards each solve window, and the DiT runs tensor-parallel over
``model`` on each rank's blocks of its weights (the card keeps the
blocks; under ``--chaos-drop`` the whole tree is kept on the host, for
the rebuild to re-slice).  Results equal the run without ``--mesh`` bit
for bit at one model rank, and within float32 rounding above it.  Rank 0
decides the serving loop's rounds and is the only rank that prints.
``--donate`` is accepted and changes nothing (eager PyTorch has no
compiled program to donate buffers to).  ``--chaos-drop N --chaos-round R`` (with ``--serve-async
--chunk-iters K``) serves through the ``ResilientServingLoop``, which
loses N ranks at round R and rebuilds the engines on the survivors:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --device cpu --serve-async --smoke \
        --requests 8 --steps-T 8 --batch-size 4 --chunk-iters 2 \
        --mesh debug --data-parallel 4 --model-parallel 1 --chaos-drop 2
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time
from pathlib import Path

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.core import ddim_coeffs, ddpm_coeffs
from repro_torch.device import resolve_device, to_host
from repro_torch.diffusion.convert import dit_init
from repro_torch.diffusion.dit import dit_apply, dit_defs
from repro_torch import comm
from repro_torch.launch.backend import apply_backend_tune, read_settings
from repro_torch.launch.mesh import init_distributed, make_mesh, mesh_names
from repro_torch.obs import Observability
from repro_torch.runtime import StragglerMitigator
from repro_torch.sampling import (Placement, SampleRequest, SamplingEngine,
                                  get_sampler)
from repro_torch.serving import (Batcher, BatchingPolicy, EngineKey,
                                 EngineRegistry, FaultInjector,
                                 RefinePlanner, RefinePolicy, RequestQueue,
                                 ResilientServingLoop, ServingLoop)
from repro_torch.tree import map_tree


def make_eps_apply(cfg):
    """Engine-shaped denoiser adapter: (params, x, taus, labels) -> eps."""
    def eps_apply(params, xw, taus_w, labels):
        return dit_apply(params, cfg, xw, taus_w, labels)
    return eps_apply


def make_placement(mesh_name: str = "none", *, data_parallel: int = 0,
                   model_parallel: int = 0, time_parallel: int = 0,
                   donate: bool = False, device=None) -> Placement:
    """Serving CLI placement flags -> a Placement.  A mesh starts the
    process group for ``device`` (nccl for cuda, gloo for cpu) and must
    use every rank of the world."""
    if mesh_name == "none":
        return Placement.host()
    device = resolve_device(device)
    init_distributed(device)
    mesh = make_mesh(mesh_name, data_parallel=data_parallel or None,
                     model_parallel=model_parallel or None,
                     time_parallel=time_parallel or None,
                     device_type=device.type)
    if mesh.mesh.numel() != comm.world():
        raise SystemExit(
            f"--mesh {mesh_name} has {mesh.mesh.numel()} ranks but the "
            f"world has {comm.world()}: launch with torchrun "
            f"--nproc-per-node {mesh.mesh.numel()}")
    return Placement.for_mesh(mesh, donate=donate)


def make_engine(params, cfg, coeffs, spec, *, num_tokens=16, device=None,
                noise_fn=None, placement: Placement = None) -> SamplingEngine:
    """The DiT's engine; on a mesh the DiT runs tensor-parallel on each
    rank's blocks of ``params`` (``dit_defs``; or ``params`` are those
    blocks already), as the JAX package's serving engine shards it."""
    return SamplingEngine(make_eps_apply(cfg), params, coeffs, spec,
                          sample_shape=(num_tokens, cfg.latent_dim),
                          device=device, noise_fn=noise_fn,
                          placement=placement, param_defs=dit_defs(cfg))


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


#: --use-pallas CLI value -> SamplerSpec.use_pallas (None = by device)
USE_PALLAS = {"auto": None, "on": True, "off": False}


def resolve_spec(args, solver: str):
    """CLI solver flags -> SamplerSpec: one resolution shared by the sync
    and the async paths."""
    if solver == "seq":
        return get_sampler("seq")
    return get_sampler(solver, order_k=args.order_k,
                       history_m=args.history_m, window=args.window,
                       use_pallas=USE_PALLAS[args.use_pallas],
                       fuse_round=args.fuse_round)


def make_engine_factory(cfg, params, args, device, *, num_tokens=16,
                        placement: Placement = None, blocks=None):
    """EngineKey -> SamplingEngine factory: one shared denoiser, device and
    placement, per-key step count and solver (the registry caches the
    instances).  On a mesh the engines of one placement share its blocks
    of ``params`` (``blocks``, when ``placement``'s are sliced already),
    sliced once from the whole tree where it is held; a new placement (a
    rebuild onto the survivors) re-slices it."""
    shared = {} if blocks is None else dict(placement=placement,
                                            blocks=blocks)

    def factory(key: EngineKey, plc: Placement = placement):
        weights = params
        if plc is not None and plc.is_sharded:
            if shared.get("placement") is not plc:
                shared.clear()
                shared.update(placement=plc, blocks=plc.shard_params(
                    params, dit_defs(cfg), resolve_device(device)))
            weights = shared["blocks"]
        return make_engine(weights, cfg, resolve_coeffs(args, key.T),
                           resolve_spec(args, key.solver),
                           num_tokens=num_tokens, device=device,
                           placement=plc)
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


def serve_async(args, cfg, params, device, placement: Placement = None,
                blocks=None):
    """Drive the ``repro_torch.serving`` stack with a simulated request
    stream; returns (stacked x0 latents, per-request stats) on rank 0
    (every other rank follows rank 0's rounds and returns (None, [])).
    ``blocks``: ``placement``'s blocks of the DiT, sliced already."""
    keys = mixed_engine_keys(args)
    factory = make_engine_factory(cfg, params, args, device,
                                  placement=placement, blocks=blocks)
    registry = EngineRegistry(factory)
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
    batcher = Batcher(policy, metrics=obs.metrics)
    if args.chaos_drop:
        if not args.chunk_iters:
            raise SystemExit("--chaos-drop requires --chunk-iters > 0 "
                             "(recovery splices fetched LaneBank state "
                             "back into live stepwise banks)")
        # the supervisor drops --chaos-drop ranks at round --chaos-round,
        # rebuilds every engine on the surviving sub-mesh (through the
        # per-placement factory) and resumes mid-solve
        loop = ResilientServingLoop(
            registry, queue, batcher, engine_factory=factory,
            placement=placement,
            injector=FaultInjector({args.chaos_round: args.chaos_drop}),
            depth=args.async_depth, chunk_iters=args.chunk_iters,
            refiner=refiner, cache=args.cache, obs=obs)
    else:
        loop = ServingLoop(registry, queue, batcher, depth=args.async_depth,
                           chunk_iters=args.chunk_iters, refiner=refiner,
                           cache=args.cache, obs=obs)
    for key in keys:  # first solves ahead of traffic: p95 is not a warmup
        engine = registry.get(key)
        registry.warmup(key, slots=loop.batcher.slots_for(engine),
                        chunk_iters=args.chunk_iters)
        print(f"warmed {key.describe()}: {engine.device}, "
              f"{engine.placement.describe(engine.denoiser_sharded)}")

    leader = loop.control.leader
    rng = np.random.default_rng(args.seed)
    gaps = simulate_arrivals(rng, args.requests, args.arrival_rate)
    tickets = []
    loop.start()
    try:
        # only rank 0 holds the queue: the other ranks follow its rounds
        for gap in (gaps if leader else []):
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
    # every rank reports: a report may poll, and a poll all-gathers
    reports = loop.bank_reports() if args.chunk_iters else {}
    if not leader:
        return None, []

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
        for key, report in sorted(reports.items()):
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
    if args.chaos_drop:
        res = loop.resilience
        unresolved = [t for t in tickets if not t.done()]
        if unresolved:
            raise SystemExit(f"{len(unresolved)} ticket(s) unresolved "
                             f"after the chaos drain")
        print(f"chaos: lost {res['device_losses']} device(s) at round "
              f"{args.chaos_round}, {res['rebuilds']} rebuild(s) onto "
              f"{len(loop._survivors())} survivor(s) in "
              f"{res['rebuild_wall_s']:.2f}s; {res['recovered_lanes']} "
              f"lane(s) recovered mid-solve (+{res['recovery_nfe']} "
              f"recovery NFE), {res['resubmitted_lanes']} resubmitted, "
              f"{res['draft_fallbacks']} draft fallback(s), "
              f"{res['retries']} in-place retries — "
              f"{len(tickets)}/{len(tickets)} tickets resolved")
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
            f"({d['slot_utilization']:.0%}) on {engine.device} x "
            f"{d['devices']} rank(s) [data={d['data_shards']} x "
            f"model={d['model_shards']} x time={d['time_shards']}], "
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
    p.add_argument("--use-pallas", default="auto",
                   choices=sorted(USE_PALLAS),
                   help="route the solver's TAA round through the "
                        "hand-written kernels of repro_torch.kernels.ops "
                        "(on), their plain PyTorch versions on any device "
                        "(off), or by the device (auto: the kernels on the "
                        "card, the plain versions on the CPU)")
    p.add_argument("--fuse-round", action="store_true",
                   help="each Anderson round (Gram + gamma solve + apply) as "
                        "ONE taa_round kernel launch on the card instead of "
                        "the staged Gram -> solve -> apply")
    p.add_argument("--backend-tune", action="store_true",
                   help="TF32 for float32 matmuls and convolutions on a "
                        "CUDA device (launch/backend.py), set before the "
                        "first model call; a no-op without one")
    p.add_argument("--mesh", default="none", choices=["none"] + mesh_names(),
                   help="registered rank mesh to place the engines on "
                        "(none = one device); launch its ranks with "
                        "torchrun --nproc-per-node N (nccl on cuda, gloo "
                        "with --device cpu)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="override the mesh's `data` axis size "
                        "(request-axis shards; 0 = registry default)")
    p.add_argument("--model-parallel", type=int, default=0,
                   help="override the mesh's `model` axis size (the DiT's "
                        "heads, MLP and adaLN columns split over it; 0 = "
                        "registry default)")
    p.add_argument("--time-parallel", type=int, default=0,
                   help="override a *-time mesh's `time` axis size (solve-"
                        "window shards within one request, bit for bit "
                        "the unsharded window; 0 = registry default)")
    p.add_argument("--donate", action="store_true",
                   help="accepted for the JAX package's flag; eager "
                        "PyTorch has no compiled program to donate "
                        "buffers to, so it changes nothing")
    p.add_argument("--chaos-drop", type=int, default=0,
                   help="chaos test (requires --serve-async --chunk-iters):"
                        " drop this many ranks from the serving mesh "
                        "mid-drain and let the elastic supervisor rebuild "
                        "the engines on the survivors; every ticket still "
                        "resolves, bit for bit (0 = no fault injection)")
    p.add_argument("--chaos-round", type=int, default=3,
                   help="supervision round at which --chaos-drop fires")
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
    placement = make_placement(args.mesh, data_parallel=args.data_parallel,
                               model_parallel=args.model_parallel,
                               time_parallel=args.time_parallel,
                               donate=args.donate, device=device)
    # only rank 0 prints
    quiet = contextlib.redirect_stdout(io.StringIO()) if comm.rank() \
        else contextlib.nullcontext()
    with quiet:
        return _serve(args, device, placement)


def _serve(args, device, placement: Placement):
    print(f"placement: {placement.describe(denoiser_sharded=True)}")
    if apply_backend_tune(["--backend-tune"] if args.backend_tune else []):
        print(f"backend tune: {read_settings()}")
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
    blocks = None
    if placement.is_sharded:
        # the card keeps this rank's blocks; the whole tree only where a
        # rebuild re-slices it onto the survivors (--chaos-drop), and
        # there on the host
        t0 = time.monotonic()
        blocks = placement.shard_params(params, dit_defs(cfg))
        t1 = time.monotonic()
        params = map_tree(to_host, params) if args.chaos_drop else None
        kept = f", the whole tree kept on the host in " \
            f"{time.monotonic() - t1} s" if args.chaos_drop else ""
        print(f"weights: this rank's blocks sliced in {t1 - t0} s{kept} "
              f"(host clock)")
    if args.serve_async:
        return serve_async(args, cfg, params, device, placement, blocks)
    if args.chaos_drop:
        raise SystemExit("--chaos-drop requires --serve-async "
                         "--chunk-iters > 0")

    coeffs = resolve_coeffs(args, args.steps_T)
    engine = make_engine(params if blocks is None else blocks, cfg, coeffs,
                         resolve_spec(args, args.solver), device=device,
                         placement=placement)

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
