"""Quickstart for the PyTorch port's sampling API, ``repro_torch.sampling``
(the port's counterpart of examples/quickstart.py).

Train a tiny DiT on synthetic latents, then:

  1. resolve sampler strategies from the registry (``get_sampler("seq")``,
     ``get_sampler("taa")``) instead of hand-building config objects;
  2. draw one sample functionally with ``repro_torch.sampling.run``:
     ParaTAA reproduces sequential DDIM within 2e-2 in ~3x fewer
     parallel steps;
  3. serve a batch of typed ``SampleRequest``s through a
     ``SamplingEngine``, the requests the solver's lane axis;
  4. give that engine an explicit ``Placement`` on a rank mesh
     (``repro_torch.launch.mesh``, a world of one rank here: gloo on the
     CPU, NCCL on the card): the request axis over ``data``, the DiT
     tensor-parallel over ``model`` on each rank's blocks of its weights,
     bit for bit the host placement at one rank, its collectives counted
     (``repro_torch.comm``);
  5. serve the same requests through the ``repro_torch.serving`` layer
     (``RequestQueue`` -> ``Ticket`` futures, a ``ServingLoop`` draining
     fixed-slot batches), bit for bit ``run_batch``;
  6. early exit (Sec 4.1): per-request ``tau`` / ``quality_steps``
     budgets on the request, and ``ServingLoop(chunk_iters=K)`` for
     iteration-level continuous batching — one blocking poll a round, a
     retired-lanes-only gather at harvest (the bank report's counters);
  7. kernel routing: ``use_pallas`` on the ``SamplerSpec`` (or
     ``serve.py --use-pallas``) sends the solver's TAA round through the
     hand-written kernels (True), their plain PyTorch versions (False), or
     by the device (None: the kernels on the card, the plain versions on
     the CPU) — the plain versions asked for on the CPU are the default
     bit for bit, and on the card within 1e-4 of the kernels;
  8. draft-and-refine serving: a ``quality_steps`` ticket resolves its
     draft stage at the budget while a ``RefinePlanner`` refines it to
     full tolerance on the same ticket; with ``cache=True`` and the
     registry's queue hooks, a repeat submission warm-starts from its
     cached trajectory (Sec 4.2);
  9. time-axis placement: a ``*-time`` mesh shards the solve WINDOW of
     each request over ``time`` (each rank evaluates its rows, one exact
     all-gather an iteration restores the window), bit for bit again;
 10. observability (``repro_torch.obs``): one ``Observability`` bundle
     wired into the queue and loop gives a metrics registry, a Chrome-
     trace span tracer and per-lane residual curves, at no extra poll;
 11. the fused Anderson round (``fuse_round``, ``serve.py --fuse-round``):
     one ``taa_round`` kernel launch an iteration on the card instead of
     the staged Gram -> solve -> apply; the engine counts the modeled
     ``update_launches`` (1 an iteration fused, 3 staged);
 12. resilience (``repro_torch.serving.resilience``): a device fault in a
     serving round goes to the ``ResilientServingLoop``'s restart policy,
     which rebuilds the engine on the surviving ranks mid-drain
     (``fetch_bank`` -> ``plan_elastic`` -> ``adopt_bank``); every ticket
     resolves bit for bit as in an uninterrupted drain.  Losing ranks
     for real takes several: ``torchrun --nproc-per-node 4 -m
     repro_torch.launch.serve --device cpu --serve-async --chunk-iters 2
     --mesh debug --data-parallel 4 --model-parallel 1 --chaos-drop 2``.

The example runs in one process; the mesh steps start a one-rank process
group and tear it down at the end.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Runs on CUDA unless ``--device cpu``.
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import comm
from repro_torch.configs.registry import ARCHS
from repro_torch.core import ddim_coeffs
from repro_torch.data.pipeline import LatentPipeline
from repro_torch.device import resolve_device
from repro_torch.diffusion import dit
from repro_torch.diffusion.convert import dit_init
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.optim import adamw_init
from repro_torch.runtime import RestartPolicy
from repro_torch.sampling import (Placement, SampleRequest, SamplingEngine,
                                  draw_noises, get_sampler, run)
from repro_torch.serving import (Batcher, BatchingPolicy, DeviceLossError,
                                 EngineKey, EngineRegistry, Observability,
                                 RefinePlanner, RefinePolicy, RequestQueue,
                                 ResilientServingLoop, ServingLoop)


def host(x) -> np.ndarray:
    """A result's array (a tensor on any device, or numpy) on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_err(a, b) -> float:
    a, b = host(a).astype(np.float64), host(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def same(results_a, results_b, exact: bool) -> bool:
    """x0 equal bit for bit (the CPU) or within 1e-4 (the card, where the
    kernels and the plain versions sum in another order)."""
    if exact:
        return all(np.array_equal(host(a.x0), host(b.x0))
                   for a, b in zip(results_a, results_b))
    return all(rel_err(a.x0, b.x0) < 1e-4 for a, b in zip(results_a,
                                                          results_b))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train-steps", type=int, default=80)
    p.add_argument("--steps-T", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu for a host run)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    exact = device.type == "cpu"
    T = args.steps_T

    # --- 1. a small DiT denoiser, briefly trained ---------------------------
    cfg = ARCHS["dit-xl"].reduced()
    params = dit_init(cfg, 0, device)
    opt = adamw_init(params)
    step = S.make_train_step(cfg)
    pipe = LatentPipeline(num_tokens=16, latent_dim=cfg.latent_dim,
                          num_classes=cfg.num_classes)
    print("training tiny DiT ...")
    for i in range(args.train_steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in pipe.batch(i, 16).items()}
        params, opt, m = step(params, opt, batch, torch.tensor(i))
    print(f"  final loss {float(m['loss']):.4f}")

    # --- 2. functional API: one request, seq vs ParaTAA ---------------------
    coeffs = ddim_coeffs(T)
    xi = draw_noises(42, coeffs, (16, cfg.latent_dim), device=device)

    def eps_fn(xw, taus):
        y = torch.full((xw.shape[0],), 3, dtype=torch.long, device=device)
        return dit.dit_apply(params, cfg, xw, taus, y)

    seq = run(get_sampler("seq"), eps_fn, coeffs, xi)
    print(f"sequential DDIM-{T}: {T} model evaluations")
    par = run(get_sampler("taa"), eps_fn, coeffs, xi)
    err = rel_err(par.x0, seq.x0)
    print(f"ParaTAA:            {par.iters} parallel steps "
          f"({T / par.iters:.1f}x fewer), rel err {err:.2e}")
    assert err < 2e-2, err

    # --- 3. batched serving: one engine, the requests as lanes --------------
    def eps_apply(params, xw, taus, labels):
        return dit.dit_apply(params, cfg, xw, taus, labels)

    def engine(spec, placement=None, param_defs=None):
        return SamplingEngine(eps_apply, params, coeffs, spec,
                              sample_shape=(16, cfg.latent_dim),
                              device=device, placement=placement,
                              param_defs=param_defs)

    taa_engine = engine(get_sampler("taa"))
    requests = [SampleRequest(label=i % cfg.num_classes, seed=100 + i)
                for i in range(4)]
    results = taa_engine.run_batch(requests, batch_size=4)
    print(f"engine: {len(results)} requests in "
          f"{taa_engine.stats['batches']} batch(es); iters per request "
          f"{[r.iters for r in results]}; blocking polls "
          f"{taa_engine.stats['blocking_polls']}; throughput "
          f"{taa_engine.throughput():.2f} req/s")
    assert taa_engine.stats["batches"] == 1 and all(r.converged
                                                    for r in results)

    # --- 4. placement: the same engine on a rank mesh -----------------------
    # one process = a world of one rank (torchrun starts more: serve.py
    # --mesh); the engine holds its data shard's lanes and all-gathers
    # what the caller reads, and with the DiT's ParamSpec tree each rank
    # keeps its blocks of the weights (tensor-parallel over `model`): at
    # one rank the results are the host placement's, bit for bit
    owned = not dist.is_initialized()
    init_distributed(device, world_size=1, rank=0)
    mesh = make_mesh("debug", data_parallel=1, model_parallel=1,
                     device_type=device.type)
    meshed = engine(get_sampler("taa"), Placement.for_mesh(mesh),
                    dit.dit_defs(cfg))
    comm.reset()
    mesh_results = meshed.run_batch(requests, batch_size=4)
    print(f"placement: {meshed.placement.describe(meshed.denoiser_sharded)}"
          f"; collectives "
          f"{comm.counts}; bit for bit the host placement: "
          f"{same(mesh_results, results, exact=True)}")
    assert same(mesh_results, results, exact=True)

    # --- 5. the serving layer: queue, tickets, a draining loop --------------
    registry = EngineRegistry(lambda key: SamplingEngine(
        eps_apply, params, ddim_coeffs(key.T), get_sampler(key.solver),
        sample_shape=(16, cfg.latent_dim), device=device))
    key = EngineKey("dit-xl", T, "taa")
    queue = RequestQueue()
    loop = ServingLoop(registry, queue,
                       Batcher(BatchingPolicy(max_batch=4, max_wait_s=0.02)))
    tickets = [queue.submit(r, key) for r in requests]
    loop.drain()
    served = [t.result() for t in tickets]
    bitwise = same(served, results, exact=True)
    print(f"async serving: {loop.stats['completed']} requests in "
          f"{loop.stats['dispatches']} dispatch(es); latencies "
          f"{[f'{t.latency_s:.2f}s' for t in tickets]}; bit for bit "
          f"run_batch: {bitwise}")
    assert bitwise

    # --- 6. early exit: per-request budgets, iteration-level lanes ----------
    mixed = [SampleRequest(label=3, seed=100),                  # full quality
             SampleRequest(label=4, seed=101, tau=1e-2),        # relaxed tau
             SampleRequest(label=5, seed=102, quality_steps=4),  # draft in 4
             SampleRequest(label=6, seed=103, quality_steps=4)]
    queue = RequestQueue()
    stepwise = ServingLoop(registry, queue,
                           Batcher(BatchingPolicy(max_batch=4)),
                           chunk_iters=2)
    tickets = [queue.submit(r, key) for r in mixed]
    stepwise.drain()
    served = [t.result() for t in tickets]
    report = stepwise.bank_reports()[key]
    print(f"early exit: iters {[r.iters for r in served]}, early-stopped "
          f"{[r.early_stopped for r in served]}; wasted lane-iters "
          f"{report['wasted_iter_frac']:.0%}")
    assert served[2].early_stopped and served[2].iters == 4
    assert served[0].converged and not served[0].early_stopped
    rounds = max(report["blocking_polls"], 1)
    print(f"host protocol: {report['host_fetch_bytes'] / rounds:.0f} B/round "
          f"over {rounds} round(s), {report['gather_launches']} retired-lane "
          f"gather(s) ({report['harvests']} harvest round(s))")
    assert report["gather_launches"] == report["harvests"]

    # --- 7. kernel routing: use_pallas --------------------------------------
    plain = run(get_sampler("taa", use_pallas=False), eps_fn, coeffs, xi)
    err = rel_err(plain.x0, par.x0)
    default = "the plain versions" if exact else "the kernels"
    print(f"kernel routing: use_pallas=False (the plain PyTorch versions) "
          f"against the default ({default} on {device.type}): {plain.iters} "
          f"vs {par.iters} steps, rel err {err:.1e}")
    assert plain.iters == par.iters
    assert err == 0.0 if exact else err < 1e-4
    if not exact:
        kernels = run(get_sampler("taa", use_pallas=True), eps_fn, coeffs,
                      xi)
        assert same([kernels], [par], exact=True)

    # --- 8. draft-and-refine: two-tier tickets + warm-start cache -----------
    queue = RequestQueue(validate=registry.validate_submit,
                         warm_start=registry.warm_start_for)
    refine = ServingLoop(registry, queue,
                         Batcher(BatchingPolicy(max_batch=4)),
                         chunk_iters=2,
                         refiner=RefinePlanner(RefinePolicy()), cache=True)
    two_tier = [SampleRequest(label=3 + i, seed=110 + i, quality_steps=2)
                for i in range(4)]
    tickets = [queue.submit(r, key) for r in two_tier]
    refine.drain()
    for t in tickets:
        final = t.result()
        assert t.draft_result() is not None
        assert final.converged and not final.early_stopped
    n_drafted = sum(1 for t in tickets if t.refines)
    print(f"draft-and-refine: {n_drafted}/{len(tickets)} tickets drafted "
          f"at 2 iters then refined to full tolerance; draft latencies "
          f"{[f'{t.draft_latency_s:.2f}s' for t in tickets]} vs final "
          f"{[f'{t.latency_s:.2f}s' for t in tickets]}")
    repeat = queue.submit(SampleRequest(label=3, seed=110), key)
    assert repeat.request.init is not None       # cache hit at submit time
    refine.drain()
    warm = repeat.result()
    cstats = registry.cache(key).stats()
    print(f"warm-start cache: {cstats['hits']}/"
          f"{cstats['hits'] + cstats['misses']} lookups hit; the repeat "
          f"submission re-converged in {warm.iters} iteration(s)")
    assert warm.converged

    # --- 9. time-axis placement: shard the solve window of each request ----
    tplc = Placement.for_mesh(make_mesh("debug-time", data_parallel=1,
                                        time_parallel=1, model_parallel=1,
                                        device_type=device.type))
    comm.reset()
    window = engine(get_sampler("taa"), tplc).run_batch(requests,
                                                        batch_size=4)
    iters = max(r.iters for r in window)
    print(f"time-axis placement: {tplc.describe()}; "
          f"{comm.counts['all-gather'] - 5} window all-gather(s) over {iters}"
          f" iteration(s); bit for bit: {same(window, results, exact=True)}")
    assert same(window, results, exact=True)

    # --- 10. observability: metrics, span traces, convergence curves --------
    obs = Observability.enabled()
    queue = RequestQueue(obs=obs)
    traced = ServingLoop(registry, queue,
                         Batcher(BatchingPolicy(max_batch=4)),
                         chunk_iters=2, obs=obs)
    tickets = [queue.submit(SampleRequest(label=3 + i, seed=130 + i), key)
               for i in range(4)]
    traced.drain()
    for t in tickets:
        t.result()
        assert t.residual_curve, "every resolved ticket carries a curve"
    curve = tickets[0].residual_curve
    lane0 = [pt["residual"] for pt in curve
             if pt["lane"] == curve[0]["lane"] and pt["residual"] is not None]
    print(f"observability: ticket #{tickets[0].seqno} residual curve over "
          f"{len(lane0)} round(s): {['%.1e' % r for r in lane0]}")
    if len(lane0) >= 2:
        assert lane0[-1] < lane0[0]               # residuals contract
    snap = obs.metrics.snapshot()
    print(f"metrics registry: {len(snap)} instruments, e.g. "
          f"loop.completed={obs.metrics.gauge('loop.completed').value()}")
    with tempfile.TemporaryDirectory() as tmp:
        path = obs.tracer.export(Path(tmp) / "trace.json")
        print(f"trace: {len(obs.tracer.events())} events -> {path.name} "
              f"(tools/obs_report.py reads it)")

    # --- 11. fused Anderson round: one update launch per iteration ----------
    fused = engine(get_sampler("taa", fuse_round=True))
    fused_results = fused.run_batch(requests, batch_size=4)
    d_f = fused.last_dispatches[-1]
    print(f"fused round: {d_f['update_launches']} update launch(es) over "
          f"{d_f['device_iters']} iteration(s) (staged would take "
          f"{3 * d_f['device_iters']}); equal to the staged engine: "
          f"{same(fused_results, results, exact)}")
    assert same(fused_results, results, exact)
    assert d_f["update_launches"] == d_f["device_iters"]

    # --- 12. resilience: a faulted round, a rebuild, no ticket dropped ------
    plc = Placement.for_mesh(mesh)

    def factory(k, placement):
        return SamplingEngine(eps_apply, params, ddim_coeffs(k.T),
                              get_sampler(k.solver),
                              sample_shape=(16, cfg.latent_dim),
                              device=device, placement=placement)

    def drain(fault_at=None):
        reg = EngineRegistry(lambda k: factory(k, plc))
        q = RequestQueue()
        lp = ResilientServingLoop(
            reg, q, Batcher(BatchingPolicy(max_batch=4)),
            engine_factory=factory, placement=plc, chunk_iters=2,
            min_full_quality_devices=1, sleep=lambda s: None,
            policy=RestartPolicy(elastic_after=0))
        tks = [q.submit(SampleRequest(label=i % cfg.num_classes,
                                      seed=140 + i), key) for i in range(4)]
        if fault_at is not None:
            eng, calls = reg.get(key), []
            real_step = eng.stepwise_step

            def flaky(bank):
                calls.append(1)
                if len(calls) == fault_at:
                    raise DeviceLossError("simulated fault in a round")
                return real_step(bank)
            eng.stepwise_step = flaky
        lp.drain()
        return lp, [t.result() for t in tks]

    _, calm = drain()
    storm_loop, storm = drain(fault_at=2)
    res = storm_loop.resilience
    print(f"resilience: a faulted round -> {res['rebuilds']} rebuild(s) in "
          f"{res['rebuild_wall_s']:.3f}s, {res['recovered_lanes']} live "
          f"lane(s) resumed ({res['rebuild_bytes']} B through the host); "
          f"every ticket resolved, bit for bit the uninterrupted drain: "
          f"{same(storm, calm, exact=True)}")
    assert res["rebuilds"] == 1 and same(storm, calm, exact=True)
    if owned:
        dist.destroy_process_group()
    return par, seq


if __name__ == "__main__":
    main()
