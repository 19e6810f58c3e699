"""repro_torch.serving — continuous-batching serving over SamplingEngines on
one device.

The blocking path (``engine.run_batch``) packs, solves and waits one batch
at a time.  This package turns that into a continuously-batched serving
layer for live traffic:

  * :class:`EngineKey` / :class:`RequestQueue` — clients submit
    ``SampleRequest``s under an (arch, T, solver) key and get a
    :class:`Ticket` future back; priority and arrival time ride ON the
    request, never in side-channel state.
  * :class:`EngineRegistry` — lazily constructs and caches ONE
    ``SamplingEngine`` per key, so the rest of the layer only routes
    requests.
  * :class:`Batcher` / :class:`BatchingPolicy` — drains queue buckets into
    FIXED-slot dispatches (``max_batch`` lanes) under a fill-or-deadline
    policy, mixing warm and cold starts freely, and folds
    ``engine.last_dispatches`` reports into per-key observed utilization.
  * :class:`ServingLoop` — the pump, driven synchronously (``drain()``) or
    as a background thread (``start()``/``stop()``).  Whole-batch mode
    keeps up to ``depth`` dispatches in flight and collects whichever is
    ready (``PendingBatch.ready()``, a CUDA event query).  With
    ``chunk_iters > 0`` it switches to ITERATION-LEVEL continuous
    batching: one live ``LaneBank`` of resumable solver state per key,
    advanced a chunk of solver iterations at a time, with lanes retiring
    the moment their own request converges (or early-exits at its
    ``tau``/``quality_steps``/``max_iters`` budget, Sec 4.1) and freed
    lanes refilled mid-solve.
  * :class:`TrajectoryCache` — per-key byte-bounded LRU of solved
    trajectories (Sec 4.2 warm starts) with (label, seed) identity and
    neighborhood lookup; the queue's ``warm_start``/``validate`` hooks
    auto-populate ``SampleRequest.init`` from it at submit time.
  * :class:`RefinePlanner` / :class:`RefinePolicy` — two-tier
    draft-and-refine serving: an early-exited draft resolves the ticket's
    DRAFT stage immediately and a warm-started, preemptible continuation
    splices back into the live bank as background work, completing the
    same ticket at full tolerance.

Observability (``repro_torch.obs``) threads through every layer: wire ONE
:class:`repro_torch.obs.Observability` into the queue and the loop and the
whole stack mirrors its counters into one metrics registry, traces each
ticket's lifecycle plus every engine span onto one Chrome-trace timeline,
and records per-lane residual-vs-round curves off the stepwise poll — all
protocol-neutral (same 5 stepwise program kinds, same one blocking poll
per live key per round, the same solves).

:class:`ResilientServingLoop` (``resilience``) supervises the stepwise
rounds: simulated device loss (:class:`FaultInjector`), a rebuild of every
live bank onto the surviving sub-mesh that resumes the solves bit for bit,
restart/backoff policy and draft-tier degradation.  On a mesh, rank 0
decides each round and the other ranks follow (``loop.RankControl``).

Results equal ``engine.run_batch`` over the same requests at the same slot
geometry: batching is a scheduling concern, not a numerics one (a lane's
state evolves as if it ran alone).  See ``launch/serve.py --serve-async``
for the live entry point.
"""
from repro_torch.obs import Observability
from repro_torch.serving.batcher import Batcher, BatchingPolicy, Dispatch
from repro_torch.serving.cache import TrajectoryCache
from repro_torch.serving.loop import ServingLoop, ShutdownError
from repro_torch.serving.queue import EngineKey, RequestQueue, Ticket
from repro_torch.serving.refine import RefinePlanner, RefinePolicy
from repro_torch.serving.registry import EngineRegistry
from repro_torch.serving.resilience import (DeviceLossError, FaultInjector,
                                            ResilientServingLoop,
                                            duplicate_window_eval)

__all__ = [
    "Batcher", "BatchingPolicy", "Dispatch",
    "ServingLoop", "ShutdownError",
    "EngineKey", "RequestQueue", "Ticket",
    "EngineRegistry", "TrajectoryCache",
    "RefinePlanner", "RefinePolicy",
    "Observability",
    "DeviceLossError", "FaultInjector", "ResilientServingLoop",
    "duplicate_window_eval",
]
