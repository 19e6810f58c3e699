"""SamplingEngine: batched execution of SampleRequests on one device.

The engine owns (denoiser apply fn, params, solver coefficients, sampler
spec, sample shape, device) and runs batches of requests through the
ParaTAA solver with the requests as its lane axis, so every solver
iteration evaluates the denoiser on a single (requests x window) batch and
every Anderson update is one kernel launch for all lanes.

Per-request labels, seeds, warm starts (Sec 4.2) and solver budgets are
per-lane data.  Host data reaches the card only through
``repro_torch.device.to_device`` (pinned memory, a copy that does not
block), so packing never waits for the stream.

Two ways to run requests:

  * whole batches: ``run_batch``, or its halves ``dispatch`` (pack +
    solve; returns once the last iteration is queued) and ``collect``
    (waits on the dispatch's own CUDA event, fetches, accounts), padded to
    a fixed slot count by repeating the last request;
  * the stepwise protocol of a :class:`LaneBank` (iteration-level
    continuous batching, what ``repro_torch.serving.ServingLoop`` drives
    with ``chunk_iters > 0``): ``stepwise_open`` (an all-vacant bank),
    ``stepwise_refill`` (pack requests into free lanes of the live state),
    ``stepwise_step`` (queue ``chunk_iters`` guarded iterations and the
    packed (slots, 5) summary's copy to pinned host memory; no wait),
    ``stepwise_poll`` (the round's one blocking read), ``stepwise_harvest``
    (gather only the retired lanes' rows) and ``stepwise_report``.
    ``fetch_bank``/``adopt_bank`` move a live bank through host memory
    with its exact bytes.

Eager PyTorch compiles nothing, so where the JAX package counts traced
programs, ``stats["stepwise_traces"]`` counts the first use of each of the
stepwise protocol's five program kinds (open, init, merge, step, gather)
per engine: a drain with mid-solve refills holds it at 5, as the
reference's does.

Noise comes from ``noise_fn(request) -> (T+1, *sample_shape)``, by default
:func:`repro_torch.diffusion.samplers.draw_noises` seeded from
``request.seed``; tests inject the JAX package's noise through it.

On a mesh (``placement=Placement.for_mesh(...)``, one process per rank)
the request axis shards over ``data``: each rank packs and solves only its
data shard's lanes (``Placement.lanes``), and what a caller reads is
all-gathered over the data group — a whole batch's outputs at the end of
``dispatch``, the (slots, 5) summary at each ``stepwise_step``, the retired
lanes' rows at harvest, the whole state at ``fetch_bank`` — so every rank
sees every lane and each round still makes one blocking poll.  A solve's
per-iteration poll reduces its finished flag over the data group, so all
shards iterate in step.  With a ``time`` axis the solve window shards over
it (``ParaTAAConfig.time_axis``).  Per-lane math does not depend on the
partition, so a sharded engine's results equal the host placement's bit
for bit.  Given ``param_defs`` (the denoiser's ``ParamSpec`` tree, as
``serve.make_engine`` passes ``dit_defs``), each rank keeps only its
blocks of the parameters (``Placement.shard_params``) and the DiT runs
tensor-parallel over ``model`` inside each (data, time) shard: bit for bit
at one model rank, and within float32 rounding of the host placement
above it (its partial sums add in another order).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import parataa as _parataa
from repro_torch.core.coeffs import SolverCoeffs
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.diffusion.samplers import _sequential_sample, draw_noises
from repro_torch.models.shardctx import ShardedParams
from repro_torch.obs import Observability, StatsView
from repro_torch.sampling.placement import Placement
from repro_torch.sampling.specs import SamplerSpec
from repro_torch.sampling.types import DIAG_KEYS, SampleRequest, SampleResult


@dataclasses.dataclass
class PendingBatch:
    """One dispatch whose outputs may still be in flight on the device.

    ``trajs``/``info`` are host tensors (pinned on the card) that the
    dispatch's outputs are being copied into without blocking; ``event`` is
    a CUDA event recorded after those copies (None on the CPU, where the
    outputs are ready when ``dispatch`` returns).  ``collect`` waits on
    that event only — not on work queued after it — and ``ready`` asks it
    without waiting."""
    trajs: torch.Tensor
    info: Dict[str, torch.Tensor]
    requests: List[SampleRequest]   # the real (unpadded) requests
    slots: int                      # padded request-slot count dispatched
    diagnostics: bool
    pack_s: float                   # host-side packing / noise wall time
    t_dispatch: float               # clock reading when the solve started
    polls: int = 0                  # host reads the solve made (its polls)
    event: Optional[torch.cuda.Event] = None

    def ready(self) -> bool:
        """Whether the outputs are computed (collecting will not block)."""
        return self.event is None or self.event.query()


@dataclasses.dataclass
class LaneBank:
    """A live, resumable batch of solver lanes (the stepwise dispatch unit).

    ``state`` is the lane-batched :class:`repro_torch.core.parataa
    .SolverState` on the engine's device (on a mesh: this rank's data
    shard of the lanes, ``Placement.lanes(slots)``); each of the ``slots``
    lanes holds
    one in-flight request (or ``None`` = vacant, kept ``finished`` by an
    iteration budget of 0, so the guarded chunk passes it through).  Lanes
    retire the moment their own request finishes and are refilled in place.

    Work accounting: ``device_iters`` counts solver iterations the device
    ran while the bank was stepped (every step costs the full bank width,
    finished or not), ``useful_iters``/``harvested_nfe`` accumulate
    per-lane progress at harvest, so ``wasted_iter_frac`` measures
    lane-iterations burned after the owning lane finished (or on vacant
    lanes).

    Host protocol state: ``summary_buf`` is the bank's (slots, 5) int32
    host buffer (pinned on the card) that each step's packed summary is
    copied into without blocking; ``summary`` is that buffer while it
    describes the current state (set by step, dropped by refill) and
    ``summary_event`` the CUDA event recorded after the copy.  ``poll_cache``
    shares the round's ONE blocking poll between harvest and report
    (invalidated by step/refill).  ``host_fetch_bytes`` /
    ``blocking_polls`` / ``gather_launches`` count what crossed to the
    host.
    """
    state: _parataa.SolverState
    labels: torch.Tensor                   # (slots,) long on the device
    requests: List[Optional[SampleRequest]]
    slots: int
    chunk_iters: int
    summary_buf: torch.Tensor              # (slots, 5) int32 host buffer
    device_iters: int = 0
    useful_iters: int = 0
    harvested_nfe: int = 0
    completed: int = 0
    refills: int = 0
    pack_s: float = 0.0
    summary: Optional[torch.Tensor] = None
    summary_event: Optional[torch.cuda.Event] = None
    poll_cache: Optional[Dict] = None      # this round's host-side poll
    host_fetch_bytes: int = 0
    blocking_polls: int = 0
    gather_launches: int = 0
    harvests: int = 0                      # rounds that retired >= 1 lane
    update_launches: int = 0               # modeled Anderson-update kernel
                                           # launches (3/iter staged, 1
                                           # fused, 0 when no update runs)

    def free_lanes(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self.requests)


@dataclasses.dataclass
class BankSnapshot:
    """A host copy of a live :class:`LaneBank`: every
    :class:`~repro_torch.core.parataa.SolverState` field as numpy
    (``state``, by field name; bfloat16 fields carry their bits as int16,
    named in ``bf16``), the lane labels, the lane requests, and the bank's
    work counters (``counters``), so ``SamplingEngine.adopt_bank`` resumes
    the solve with the exact bytes and a report that covers the bank's
    whole life."""
    state: Dict[str, np.ndarray]
    labels: np.ndarray                      # (slots,) int64
    requests: List[Optional[SampleRequest]]
    slots: int
    chunk_iters: int
    counters: Dict[str, object] = dataclasses.field(default_factory=dict)
    bf16: tuple = ()

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self.requests)

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.state.values())
                   + self.labels.nbytes)


class SamplingEngine:
    """Batched sampling executor for one (denoiser, T, solver) configuration.

    eps_apply:    (params, x (n, *sample_shape), taus (n,), labels (n,)) -> eps
    params:       denoiser parameters, passed through to ``eps_apply``
    coeffs:       SolverCoeffs (fixes T and the DDIM/DDPM schedule)
    spec:         SamplerSpec strategy ("seq" or any ParaTAA variant)
    sample_shape: per-sample latent shape, e.g. (num_tokens, latent_dim)
    device:       where the solve runs; None = cuda (raises without CUDA)
    placement:    :class:`~repro_torch.sampling.Placement` (rank mesh and
                  lane/window layout); default the host placement
    param_defs:   the denoiser's ``ParamSpec`` tree: on a mesh placement
                  each rank keeps its blocks of ``params`` by their
                  logical axes, on ``device``, and the denoiser runs
                  tensor-parallel (``Placement.shard_params``); None = the
                  whole tree on every rank.  ``params`` that are already a
                  rank's ``ShardedParams`` on the placement's mesh are
                  used as they are (engines of one placement can share
                  them)
    noise_fn:     request -> (T+1, *sample_shape) noise; default draws from
                  a torch.Generator seeded with ``request.seed``
    clock:        monotonic timestamp source for ``wall_s``/``pack_s`` and
                  span timing (never wall clock)
    obs:          optional :class:`repro_torch.obs.Observability` bundle;
                  default a private disabled one (``Observability.off()``),
                  so instrumentation never branches.  ``bind_obs`` re-homes
                  the engine onto a shared bundle after construction.
    name:         label of this engine's metric series and trace track
                  (``EngineRegistry`` binds the engine key's description)
    """

    #: ``last_dispatches`` cap
    MAX_DISPATCH_REPORTS = 256

    def __init__(self, eps_apply: Callable, params, coeffs: SolverCoeffs,
                 spec: SamplerSpec, *, sample_shape: Sequence[int],
                 dtype=torch.float32, device: DeviceLike = None,
                 placement: Optional[Placement] = None, param_defs=None,
                 noise_fn: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic,
                 obs: Optional[Observability] = None,
                 name: Optional[str] = None):
        self.eps_apply = eps_apply
        self.coeffs = coeffs
        self.spec = spec
        self.sample_shape = tuple(sample_shape)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.placement = placement or Placement.host()
        if isinstance(params, ShardedParams):
            if params.mesh is not self.placement.mesh:
                raise ValueError("params: blocks of another mesh than the "
                                 "placement's")
        elif self.placement.is_sharded and params is not None:
            params = self.placement.shard_params(params, param_defs,
                                                 self.device)
        self.params = params
        #: whether the denoiser runs on this rank's blocks over ``model``
        self.denoiser_sharded = isinstance(params, ShardedParams)
        self.noise_fn = noise_fn or self.draw_request_noise
        self._clock = clock
        self.obs = obs if obs is not None else Observability.off()
        self.name = name or "engine"
        self._stepwise_kinds = set()   # stepwise program kinds used so far
        self.stats = StatsView(
            self.obs.metrics, "engine", labels={"engine": self.name},
            initial={"stepwise_traces": 0, "batches": 0, "requests": 0,
                     "wall_s": 0.0, "pack_s": 0.0, "host_fetch_bytes": 0,
                     "blocking_polls": 0, "gather_launches": 0,
                     "update_launches": 0})
        self.last_dispatches: List[Dict] = []

    def bind_obs(self, obs: Observability, name: Optional[str] = None) -> None:
        """Re-home this engine onto a shared observability bundle: its
        ``stats`` view starts mirroring into the shared registry (replaying
        current values) and its spans land on the shared tracer.  ``stats``
        keeps its identity."""
        self.obs = obs
        if name is not None:
            self.name = name
        self.stats.rebind(obs.metrics, labels={"engine": self.name})

    @property
    def _tracer(self):
        return self.obs.tracer

    @property
    def window(self) -> int:
        """eps evaluations per solver iteration per lane (1 for seq)."""
        T = self.coeffs.T
        if self.spec.is_sequential:
            return 1
        return min(self.spec.window or T, T)

    def _solver_cfg(self, cfg: _parataa.ParaTAAConfig
                    ) -> _parataa.ParaTAAConfig:
        """Thread the placement's time axis into a solver config: the solve
        window's eps rows shard over it (bit for bit the unsharded solve).
        Set whenever the mesh has the axis, also at one time shard, so a
        mesh of one rank issues the same collectives."""
        if self.placement.time_axis is not None:
            return dataclasses.replace(cfg,
                                       time_axis=self.placement.time_axis)
        return cfg

    def _report_placement(self, n_real: int, slots: int) -> Dict:
        plc = self.placement
        return dict(
            slot_utilization=plc.slot_utilization(n_real, slots),
            axis_utilization=plc.axis_utilization(n_real, slots,
                                                  self.window),
            devices=plc.num_devices, data_shards=plc.data_shards,
            model_shards=plc.model_shards, time_shards=plc.time_shards,
            denoiser_sharded=self.denoiser_sharded)

    def update_launches_per_iter(self) -> int:
        """Modeled launches per solver iteration of the Anderson UPDATE
        stage (the JAX package's counter, kept under its name): 3 for the
        staged round (Gram pass + solve stage + apply pass), 1 when the
        round is one ``ops.taa_round`` kernel, 0 when no Anderson update
        runs (seq, fp, history_m <= 1)."""
        if self.spec.is_sequential:
            return 0
        cfg = self.spec.solver_config(self.coeffs.T)
        if cfg.history_m <= 1 or cfg.mode in ("fp", "seq"):
            return 0
        return 1 if cfg.fuse_round else 3

    # -- request packing -----------------------------------------------------

    def draw_request_noise(self, request: SampleRequest) -> torch.Tensor:
        return draw_noises(request.seed, self.coeffs, self.sample_shape)

    def _pack(self, requests: Sequence[SampleRequest]):
        """-> per-lane tensors on the engine's device: xis, x0s (B, T+1,
        *sample_shape) f32; labels, t_inits, iter_caps (B,) long; tau_sqs
        (B,) f32.  Built on the host and copied with ``to_device`` (pinned,
        no wait for the stream): a refill packs between rounds while the
        previous chunk still runs."""
        T = self.coeffs.T
        shape = (T + 1,) + self.sample_shape
        xis, x0s, labels, t_inits, tau_sqs, iter_caps = [], [], [], [], [], []
        for req in requests:
            xi = _host_f32(self.noise_fn(req)).reshape(shape)
            xis.append(xi)
            labels.append(req.label)
            tau_sqs.append(self.spec.request_tau_sq(req))
            iter_caps.append(self.spec.request_iter_cap(req, T))
            if req.init is None:
                x0s.append(xi)          # cold start: noise-initialized
                t_inits.append(T)
            else:
                # warm starts pack as f32 whatever precision they were
                # recorded in; t_init None => full restart, 0 => verify only
                x0s.append(_host_f32(req.init.trajectory).reshape(shape))
                t_inits.append(T if req.init.t_init is None
                               else req.init.t_init)
        dev = self.device
        return (to_device(np.stack(xis), torch.float32, dev),
                to_device(labels, torch.long, dev),
                to_device(np.stack(x0s), torch.float32, dev),
                to_device(t_inits, torch.long, dev),
                to_device(np.asarray(tau_sqs, np.float32), torch.float32,
                          dev),
                to_device(iter_caps, torch.long, dev))

    # -- execution -----------------------------------------------------------

    def _solve(self, xis, labels, x0s, t_inits, tau_sqs, iter_caps,
               diagnostics: bool):
        coeffs, spec = self.coeffs, self.spec
        T = coeffs.T
        B = xis.shape[0]
        eps_fn = self._lane_eps(labels)

        if spec.is_sequential:
            traj = _sequential_sample(eps_fn, coeffs, xis, return_traj=True)
            full = torch.full((B,), T, dtype=torch.long, device=xis.device)
            return traj, dict(iters=full, nfe=full.clone(),
                              converged=torch.ones_like(full,
                                                        dtype=torch.bool)), 0
        solver = self._solver_cfg(spec.solver_config(T))
        plc = self.placement
        kw = {} if diagnostics else {
            "lane_axis": plc.data_axis if plc.is_sharded else None}
        fn = _parataa.sample_recording if diagnostics else _parataa.sample
        traj, info = fn(eps_fn, coeffs, solver, xis, x_init=x0s,
                        dtype=self.dtype, t_init=t_inits, tau_sq=tau_sqs,
                        iter_cap=iter_caps, **kw)
        keep = ("iters", "nfe", "converged", "residuals") + \
            (DIAG_KEYS if diagnostics else ())
        return traj, {k: info[k] for k in keep if k in info}, \
            info.get("polls", 0)

    def _lane_eps(self, labels: torch.Tensor) -> Callable:
        """eps_fn over every lane's window, lane-major (B * w samples),
        each sample conditioned on its lane's label."""
        B = labels.shape[0]

        def eps_fn(xw, taus):
            w = xw.shape[0] // B
            y = labels[:, None].expand(B, w).reshape(B * w)
            return self.eps_apply(self.params, xw, taus, y)

        return eps_fn

    def _record_event(self) -> Optional[torch.cuda.Event]:
        """A CUDA event recorded on the engine's current stream after
        everything queued so far (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def run(self, request: SampleRequest, **kw) -> SampleResult:
        return self.run_batch([request], **kw)[0]

    def dispatch(self, requests: Sequence[SampleRequest], *,
                 slots: Optional[int] = None,
                 diagnostics: bool = False) -> PendingBatch:
        """Pack ``requests`` and solve them as ONE lane batch, padded to
        ``slots`` lanes (default: the request count) by repeating the last
        request.  The host loop polls whether every lane has finished once
        per iteration (``parataa.poll_finished``, its only wait on the
        card), so this returns once the solve's last kernels are queued,
        with a CUDA event recorded after them; ``collect`` waits on that
        event."""
        requests = list(requests)
        if not requests:
            raise ValueError("dispatch needs at least one request")
        self.spec.check_request_flags(
            diagnostics=diagnostics,
            warm_start=any(r.init is not None for r in requests),
            solver_overrides=any(r.has_solver_overrides for r in requests))
        plc = self.placement
        B = plc.round_batch(slots or len(requests))
        if len(requests) > B:
            raise ValueError(
                f"{len(requests)} requests exceed {B} request slots")
        chunk = requests + [requests[-1]] * (B - len(requests))
        lo, hi = plc.lanes(B)
        t0 = self._clock()
        with self._tracer.span("engine.pack", tid=self.name,
                               requests=len(requests), slots=B):
            packed = self._pack(chunk[lo:hi])
        t1 = self._clock()
        with self._tracer.span("engine.dispatch", tid=self.name, slots=B):
            with torch.inference_mode(), plc.activations():
                trajs, info, polls = self._solve(*packed,
                                                 diagnostics=diagnostics)
                # every data shard's lanes, in slot order, on every rank
                trajs = plc.gather_lanes(trajs)
                info = {k: plc.gather_lanes(v) for k, v in info.items()}
                trajs = _to_host_async(trajs)
                info = {k: _to_host_async(v) for k, v in info.items()}
            event = self._record_event()
        return PendingBatch(trajs=trajs, info=info, requests=requests,
                            slots=B, diagnostics=diagnostics,
                            pack_s=t1 - t0, t_dispatch=t1, polls=polls,
                            event=event)

    def collect(self, pending: PendingBatch) -> List[SampleResult]:
        """Wait for one dispatch (its own event, not the whole device),
        record its stats, unpack its results.

        ``wall_s`` spans solve start -> outputs ready on the device."""
        with self._tracer.span("engine.collect", tid=self.name,
                               requests=len(pending.requests)):
            if pending.event is not None:
                pending.event.synchronize()
        wall = self._clock() - pending.t_dispatch
        n_real = len(pending.requests)
        self.stats["batches"] += 1
        self.stats["requests"] += n_real
        self.stats["wall_s"] += wall
        self.stats["pack_s"] += pending.pack_s

        # what crossed to the host: the solve's polls (one flag each) and
        # ONE fetch of the outputs, sliced per request in numpy
        fetched = sum(t.numel() * t.element_size()
                      for t in [pending.trajs, *pending.info.values()]) \
            + pending.polls * _parataa.POLL_BYTES
        polls = pending.polls + 1
        trajs = _to_numpy(pending.trajs)
        info = {k: _to_numpy(v) for k, v in pending.info.items()}
        self.stats["blocking_polls"] += polls
        self.stats["host_fetch_bytes"] += fetched

        # every lane runs until the SLOWEST lane's iteration count:
        # wasted_iter_frac is the lane-iteration share spent past a lane's
        # own finish (plus padding lanes)
        all_iters = np.asarray(info["iters"], np.int64)
        device_iters = int(all_iters.max()) if all_iters.size else 0
        update_launches = device_iters * self.update_launches_per_iter()
        self.stats["update_launches"] += update_launches
        res_batch = info.get("residuals")
        self.last_dispatches.append(dict(
            update_launches=update_launches,
            residual=[_finite_or_none(np.max(res_batch[i]))
                      for i in range(n_real)]
            if res_batch is not None else [None] * n_real,
            wall_s=wall, pack_s=pending.pack_s,
            host_fetch_bytes=fetched, blocking_polls=polls,
            requests=n_real, slots=pending.slots,
            **self._report_placement(n_real, pending.slots),
            iters=[int(i) for i in all_iters[:n_real]],
            nfe=[int(n) for n in info["nfe"][:n_real]],
            warm_start_depth=[self._warm_depth(r) for r in pending.requests],
            **self._work_report(int(all_iters[:n_real].sum()),
                                device_iters, pending.slots)))
        del self.last_dispatches[:-self.MAX_DISPATCH_REPORTS]

        T = self.coeffs.T
        results: List[SampleResult] = []
        for i, req in enumerate(pending.requests):
            diag = None
            if pending.diagnostics:
                diag = {k: info[k][i] for k in DIAG_KEYS}
            res = info.get("residuals")
            iters = int(info["iters"][i])
            converged = bool(info["converged"][i])
            results.append(SampleResult(
                x0=trajs[i, 0], trajectory=trajs[i],
                iters=iters, nfe=int(info["nfe"][i]),
                converged=converged,
                early_stopped=self.spec.request_early_stopped(
                    req, T, iters, converged),
                residuals=None if res is None else res[i],
                diagnostics=diag, request=req, wall_s=wall))
        return results

    def _warm_depth(self, request: Optional[SampleRequest]) -> int:
        """-1 = cold start, T = full restart from a warm trajectory,
        0..T-1 = a partial resume with that many rows still active."""
        if request is None or request.init is None:
            return -1
        return self.coeffs.T if request.init.t_init is None \
            else int(request.init.t_init)

    def _work_report(self, useful_iters: int, device_iters: int,
                     slots: int) -> Dict:
        capacity = device_iters * slots
        return dict(
            device_iters=device_iters,
            device_nfe=capacity * self.window,
            wasted_iter_frac=1.0 - useful_iters / capacity
            if capacity else 0.0)

    def run_batch(self, requests: Sequence[SampleRequest], *,
                  batch_size: Optional[int] = None,
                  diagnostics: bool = False) -> List[SampleResult]:
        """Run all requests, ``batch_size`` at a time (default: one batch);
        the final partial batch is padded to the same slot count."""
        if not requests:
            return []
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        B = self.placement.round_batch(batch_size or len(requests))
        self.last_dispatches = []
        results: List[SampleResult] = []
        for lo in range(0, len(requests), B):
            pending = self.dispatch(requests[lo:lo + B], slots=B,
                                    diagnostics=diagnostics)
            results.extend(self.collect(pending))
        return results

    def validate_request(self, request: SampleRequest) -> None:
        """Raise exactly what a dispatch carrying ``request`` would raise."""
        self.spec.check_request_flags(
            warm_start=request.init is not None,
            solver_overrides=request.has_solver_overrides)
        if request.init is not None:
            self._validate_init(request.init)

    def _validate_init(self, init) -> None:
        """Structural warm-start checks against this engine's geometry —
        shape/dtype metadata only."""
        T = self.coeffs.T
        traj = init.trajectory
        shape = tuple(getattr(traj, "shape", None) or np.shape(traj))
        want_shape = (T + 1,) + self.sample_shape
        if not shape or shape[0] != T + 1 or \
                int(np.prod(shape, dtype=np.int64)) != \
                int(np.prod(want_shape, dtype=np.int64)):
            raise ValueError(
                f"warm-start trajectory shape {shape} does not match this "
                f"engine's (T+1, *sample_shape) = {want_shape} "
                f"(T={T}, sample_shape={self.sample_shape})")
        dtype = getattr(traj, "dtype", None)
        if dtype is None:
            dtype = np.asarray(traj).dtype
        floating = dtype.is_floating_point if isinstance(dtype, torch.dtype) \
            else np.issubdtype(dtype, np.floating) or str(dtype) == "bfloat16"
        if not floating:
            raise ValueError(
                f"warm-start trajectory dtype {dtype} is not a floating "
                f"type; pack casts warm starts to float32")
        t_init = init.t_init
        if t_init is not None and not 0 <= int(t_init) <= T:
            raise ValueError(
                f"warm-start t_init={t_init} outside [0, T={T}]")

    # -- stepwise (iteration-level) execution --------------------------------
    #
    # One LaneBank per engine holds a live lane-batched SolverState;
    # `stepwise_step` advances every lane by `chunk_iters` guarded solver
    # iterations, `stepwise_harvest` retires lanes the moment THEIR OWN
    # solve finishes (convergence, max_iters, or a Sec 4.1 quality-steps
    # early exit), and `stepwise_refill` packs fresh requests into the
    # vacated lanes of the SAME live state.  Five program kinds in all:
    # open (vacant bank), init (the refilled lanes' fresh state), merge
    # (select it into those lanes), step (the chunk plus the packed
    # (slots, 5) summary) and gather (only the retired lanes' rows).

    def _stepwise_cfg(self) -> _parataa.ParaTAAConfig:
        return self._solver_cfg(self.spec.stepwise_config(self.coeffs.T))

    def _note_program(self, kind: str) -> None:
        """Count the first use of a stepwise program kind (the port's
        ``stepwise_traces``: eager PyTorch has nothing to trace)."""
        if kind not in self._stepwise_kinds:
            self._stepwise_kinds.add(kind)
            self.stats["stepwise_traces"] += 1

    def stepwise_open(self, slots: int, *, chunk_iters: int) -> LaneBank:
        """Open an all-vacant LaneBank of ``slots`` lanes: every lane's
        iteration budget is 0, so it is finished from the start and chunks
        pass it through until a refill."""
        if chunk_iters < 1:
            raise ValueError(f"chunk_iters must be >= 1, got {chunk_iters}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        T, dev = self.coeffs.T, self.device
        slots = self.placement.round_batch(slots)
        lo, hi = self.placement.lanes(slots)
        t0 = self._clock()
        with self._tracer.span("stepwise.open", tid=self.name, slots=slots):
            with torch.inference_mode():
                xi = torch.zeros((hi - lo, T + 1) + self.sample_shape,
                                 dtype=torch.float32, device=dev)
                state = _parataa.init_state(self.coeffs, self._stepwise_cfg(),
                                            xi, dtype=self.dtype,
                                            iter_cap=0)
                labels = torch.zeros((hi - lo,), dtype=torch.long,
                                     device=dev)
            buf = torch.zeros((slots, 5), dtype=torch.int32,
                              pin_memory=dev.type == "cuda")
        self._note_program("open")
        bank = LaneBank(state=state, labels=labels, requests=[None] * slots,
                        slots=slots, chunk_iters=chunk_iters,
                        summary_buf=buf)
        bank.pack_s += self._clock() - t0
        return bank

    def stepwise_refill(self, bank: LaneBank, lanes: Sequence[int],
                        requests: Sequence[SampleRequest]) -> None:
        """Pack ``requests`` into the given vacant ``lanes`` of the live
        bank state.  Only the admitted requests are packed (their noise
        drawn); ``index_select`` spreads their rows over the lane positions
        and a per-lane select merges them in, so lanes outside the refill
        keep their state.  Nothing is read on the host."""
        requests = list(requests)
        if len(requests) != len(lanes):
            raise ValueError(f"{len(requests)} requests for "
                             f"{len(lanes)} lanes")
        if not requests:
            return
        taken = [bank.requests[lane] for lane in lanes]
        if any(r is not None for r in taken):
            raise ValueError(f"lanes {list(lanes)} are not all vacant")
        self.spec.check_request_flags(
            warm_start=any(r.init is not None for r in requests),
            solver_overrides=any(r.has_solver_overrides for r in requests))
        t0 = self._clock()
        dev = self.device
        # this rank packs only the requests of its own data shard's lanes
        lo, hi = self.placement.lanes(bank.slots)
        mine = [(lane, req) for lane, req in zip(lanes, requests)
                if lo <= lane < hi]
        with self._tracer.span("stepwise.refill", tid=self.name,
                               lanes=len(lanes)):
            if mine:
                with torch.inference_mode():
                    xis, labels, x0s, t_inits, tau_sqs, iter_caps = \
                        self._pack([req for _, req in mine])
                    pos = {lane - lo: i for i, (lane, _) in enumerate(mine)}
                    idx = to_device([pos.get(j, 0) for j in range(hi - lo)],
                                    torch.long, dev)
                    refill = to_device([j in pos for j in range(hi - lo)],
                                       torch.bool, dev)

                    def spread(a):
                        return a.index_select(0, idx)

                    fresh = _parataa.init_state(
                        self.coeffs, self._stepwise_cfg(), spread(xis),
                        x_init=spread(x0s), dtype=self.dtype,
                        t_init=spread(t_inits), tau_sq=spread(tau_sqs),
                        iter_cap=spread(iter_caps))
                    bank.state = fresh.keep_where(refill, bank.state)
                    bank.labels = torch.where(refill, spread(labels),
                                              bank.labels)
        self._note_program("init")
        self._note_program("merge")
        for lane, req in zip(lanes, requests):
            bank.requests[lane] = req
        # the last step's summary no longer describes the refilled lanes:
        # the next poll (only a report issued before the next step) reads
        # the state fields instead
        bank.summary = None
        bank.summary_event = None
        bank.poll_cache = None
        bank.refills += 1
        bank.pack_s += self._clock() - t0

    def stepwise_step(self, bank: LaneBank) -> None:
        """Queue ``bank.chunk_iters`` guarded solver iterations on every
        lane, then the packed (slots, 5) summary's copy into the bank's
        host buffer and an event behind it.  Does not wait: the next
        ``stepwise_poll`` does, on that event."""
        with self._tracer.span("stepwise.step", tid=self.name,
                               chunk_iters=bank.chunk_iters,
                               occupied=bank.occupied):
            with torch.inference_mode(), self.placement.activations():
                state = _parataa.step_chunk(
                    self._lane_eps(bank.labels), self.coeffs,
                    self._stepwise_cfg(), bank.state, bank.chunk_iters,
                    sample_shape=self.sample_shape)
                bank.summary_buf.copy_(
                    self.placement.gather_lanes(
                        _parataa.lane_summary(state)), non_blocking=True)
            bank.summary_event = self._record_event()
        self._note_program("step")
        bank.state = state
        bank.summary = bank.summary_buf
        bank.poll_cache = None
        bank.device_iters += bank.chunk_iters
        launches = bank.chunk_iters * self.update_launches_per_iter()
        bank.update_launches += launches
        self.stats["update_launches"] += launches

    def _count_fetch(self, bank: LaneBank, nbytes: int, *,
                     polls: int = 0, gathers: int = 0) -> None:
        bank.host_fetch_bytes += nbytes
        bank.blocking_polls += polls
        bank.gather_launches += gathers
        self.stats["host_fetch_bytes"] += nbytes
        self.stats["blocking_polls"] += polls
        self.stats["gather_launches"] += gathers

    def stepwise_poll(self, bank: LaneBank) -> Dict[str, np.ndarray]:
        """The round's per-lane scheduling view, and its ONE blocking read:
        wait on the last step's event, then copy its (slots, 5) summary out
        of the host buffer (before a later step can overwrite it).  Cached
        on the bank, so harvest and report share it until step/refill
        invalidate it."""
        if bank.poll_cache is not None:
            return bank.poll_cache
        if bank.summary is not None:
            with self._tracer.span("stepwise.poll", tid=self.name):
                if bank.summary_event is not None:
                    bank.summary_event.synchronize()
                packed = bank.summary.numpy().copy()
            # column 4 carries the f32 per-lane residual's bits; .copy()
            # first — a column slice is non-contiguous, which .view cannot
            # reinterpret
            polled = dict(finished=packed[:, 0].astype(bool),
                          iters=packed[:, 1], nfe=packed[:, 2],
                          done=packed[:, 3].astype(bool),
                          residual=packed[:, 4].copy().view(np.float32))
            self._count_fetch(bank, packed.nbytes, polls=1)
        else:
            # no chunk has run since open/refill: read the state fields,
            # in the reference's dtypes
            state = bank.state
            gather = self.placement.gather_lanes
            with self._tracer.span("stepwise.poll", tid=self.name,
                                   fallback=True):
                with torch.inference_mode():
                    polled = dict(
                        finished=_to_numpy(gather(state.finished)),
                        iters=_to_numpy(gather(state.it.to(torch.int32))),
                        nfe=_to_numpy(gather(state.nfe.to(torch.int32))),
                        done=_to_numpy(gather(state.done)),
                        residual=_to_numpy(gather(
                            _parataa.lane_residual(state).float())))
            self._count_fetch(bank, sum(v.nbytes for v in polled.values()),
                              polls=1)
        bank.poll_cache = polled
        return polled

    def stepwise_harvest(self, bank: LaneBank):
        """Retire every occupied lane whose OWN solve has finished: returns
        ``[(lane, SampleResult), ...]`` and vacates those lanes (their state
        stays ``finished``, so later chunks pass them through until refill).

        Only the retired lanes' rows cross to the host: one gather
        (:meth:`_gather_ready`) and a ``len(ready) x (T+1) x D`` fetch;
        sequential specs skip the residual rows (they discard them)."""
        if not any(req is not None for req in bank.requests):
            return []                       # idle bank: nothing to poll
        polled = self.stepwise_poll(bank)
        ready = [i for i, req in enumerate(bank.requests)
                 if req is not None and polled["finished"][i]]
        if not ready:
            return []
        T = self.coeffs.T
        n = len(ready)
        with self._tracer.span("stepwise.harvest", tid=self.name, retired=n):
            with torch.inference_mode():
                xg, rg = self._gather_ready(bank, ready)
                fetched = xg.numel() * xg.element_size()
                trajs = _to_numpy(xg).reshape((n, T + 1) + self.sample_shape)
                residuals = None
                if rg is not None:
                    fetched += rg.numel() * rg.element_size()
                    residuals = _to_numpy(rg)
        self._note_program("gather")
        self._count_fetch(bank, fetched, gathers=1)
        bank.harvests += 1
        out = []
        for j, lane in enumerate(ready):
            req = bank.requests[lane]
            iters = int(polled["iters"][lane])
            nfe = int(polled["nfe"][lane])
            converged = bool(polled["done"][lane])
            out.append((lane, SampleResult(
                x0=trajs[j, 0], trajectory=trajs[j],
                iters=iters, nfe=nfe, converged=converged,
                early_stopped=self.spec.request_early_stopped(
                    req, T, iters, converged),
                residuals=None if residuals is None else residuals[j],
                request=req)))
            bank.requests[lane] = None
            bank.useful_iters += iters
            bank.harvested_nfe += nfe
            bank.completed += 1
        return out

    def _gather_ready(self, bank: LaneBank, ready: List[int]):
        """The retired lanes' trajectory (and, but for seq, residual) rows,
        in ``ready``'s (ascending) order: each data shard selects its own
        retired lanes (``index_select``, padded by repeating one to the
        most any shard retired) and one all-gather over the data group
        brings them to every rank; the padding rows are dropped."""
        plc = self.placement
        width = bank.slots // plc.data_shards
        per = [[lane % width for lane in ready if lane // width == d]
               for d in range(plc.data_shards)]
        most = max(len(p) for p in per)
        mine = per[plc.data_index]
        idx = to_device(mine + [mine[0] if mine else 0] * (most - len(mine)),
                        torch.long, self.device)
        keep = None
        if len(ready) < most * plc.data_shards:
            keep = to_device([d * most + j for d, p in enumerate(per)
                              for j in range(len(p))], torch.long,
                             self.device)

        def gather(t):
            out = plc.gather_lanes(t.index_select(0, idx))
            return out if keep is None else out.index_select(0, keep)

        rg = None if self.spec.is_sequential else gather(bank.state.r_last)
        return gather(bank.state.x), rg

    def stepwise_report(self, bank: LaneBank) -> Dict:
        """Work-accounting snapshot of a bank, shaped like a
        ``last_dispatches`` entry.  Reuses the round's cached poll when
        harvest already paid for it: reporting never adds a second
        blocking read to a round."""
        polled = self.stepwise_poll(bank)
        live_iters = int(sum(polled["iters"][i]
                             for i, r in enumerate(bank.requests)
                             if r is not None))
        useful = bank.useful_iters + live_iters
        return dict(
            slots=bank.slots, chunk_iters=bank.chunk_iters,
            completed=bank.completed, refills=bank.refills,
            occupied=bank.occupied, pack_s=bank.pack_s,
            useful_iters=useful,
            residual=[_finite_or_none(polled["residual"][i])
                      if bank.requests[i] is not None else None
                      for i in range(bank.slots)],
            warm_start_depth=[self._warm_depth(r) for r in bank.requests],
            host_fetch_bytes=bank.host_fetch_bytes,
            blocking_polls=bank.blocking_polls,
            gather_launches=bank.gather_launches,
            harvests=bank.harvests,
            update_launches=bank.update_launches,
            **self._report_placement(bank.occupied, bank.slots),
            **self._work_report(useful, bank.device_iters, bank.slots))

    # -- moving a bank through host memory -----------------------------------

    #: LaneBank counters a snapshot carries, so an adopted bank's report
    #: still covers its whole life
    _CARRIED_COUNTERS = ("device_iters", "useful_iters", "harvested_nfe",
                         "completed", "refills", "pack_s",
                         "host_fetch_bytes", "blocking_polls",
                         "gather_launches", "harvests", "update_launches")

    def fetch_bank(self, bank: LaneBank) -> BankSnapshot:
        """Copy a live bank's whole solver state to the host as a
        :class:`BankSnapshot`: one blocking fetch of every state field (not
        the summary path: the exact bytes are the point), counted as one
        blocking poll plus its bytes."""
        gather = self.placement.gather_lanes
        with self._tracer.span("stepwise.fetch_bank", tid=self.name,
                               slots=bank.slots, occupied=bank.occupied):
            with torch.inference_mode():
                state, bf16 = {}, []
                for f in dataclasses.fields(bank.state):
                    t = gather(getattr(bank.state, f.name))
                    if t.dtype == torch.bfloat16:
                        t = t.view(torch.int16)
                        bf16.append(f.name)
                    state[f.name] = t.cpu().numpy()
                labels = gather(bank.labels).cpu().numpy()
        snap = BankSnapshot(
            state=state, labels=labels, requests=list(bank.requests),
            slots=bank.slots, chunk_iters=bank.chunk_iters,
            counters={k: getattr(bank, k) for k in self._CARRIED_COUNTERS},
            bf16=tuple(bf16))
        self._count_fetch(bank, snap.nbytes(), polls=1)
        snap.counters["host_fetch_bytes"] = bank.host_fetch_bytes
        snap.counters["blocking_polls"] = bank.blocking_polls
        return snap

    def adopt_bank(self, snapshot: BankSnapshot, *,
                   chunk_iters: Optional[int] = None) -> LaneBank:
        """A live :class:`LaneBank` on this engine's device (its data
        shard's lanes, on a mesh) with the snapshot's exact bytes: the next
        ``stepwise_step`` resumes the solve where ``fetch_bank`` froze it,
        bit for bit, whatever placement it was fetched from.  The first
        poll after it reads the state fields (still one blocking poll for
        that round)."""
        dev = self.device
        B = snapshot.slots
        if self.placement.round_batch(B) != B:
            raise ValueError(
                f"snapshot slots={B} do not divide the adopting engine's "
                f"data shards ({self.placement.data_shards}); rebuild with "
                f"a compatible data-parallel degree")
        lo, hi = self.placement.lanes(B)
        with self._tracer.span("stepwise.adopt_bank", tid=self.name,
                               slots=snapshot.slots,
                               occupied=snapshot.occupied):
            fields = {}
            for name, arr in snapshot.state.items():
                t = torch.from_numpy(arr[lo:hi].copy())
                if name in snapshot.bf16:
                    t = t.view(torch.bfloat16)
                fields[name] = to_device(t, t.dtype, dev)
            state = _parataa.SolverState(**fields)
            labels = to_device(snapshot.labels[lo:hi], torch.long, dev)
            buf = torch.zeros((snapshot.slots, 5), dtype=torch.int32,
                              pin_memory=dev.type == "cuda")
        return LaneBank(state=state, labels=labels,
                        requests=list(snapshot.requests),
                        slots=snapshot.slots,
                        chunk_iters=int(chunk_iters or snapshot.chunk_iters),
                        summary_buf=buf, **snapshot.counters)

    def reset_stats(self) -> None:
        """Rewind the serving counters and dispatch reports (e.g. after a
        warmup), keeping ``stepwise_traces``: program kinds already used
        stay used.  Zeroes every other key through the view, so the
        registry mirror follows."""
        for key, value in list(self.stats.items()):
            if key == "stepwise_traces":
                continue
            self.stats[key] = 0.0 if isinstance(value, float) else 0
        self.last_dispatches = []

    def throughput(self) -> float:
        """Requests per second over every batch this engine has run."""
        return self.stats["requests"] / max(self.stats["wall_s"], 1e-9)


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor's copy into pinned host memory, queued without
    blocking (read it only after an event recorded behind the copy); a
    CPU tensor as it is."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _host_f32(a) -> np.ndarray:
    """Host data (numpy, list, CPU or device tensor) -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy (bf16, which numpy lacks, as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _finite_or_none(value) -> Optional[float]:
    """+inf (a lane that never produced a first-order residual) -> None."""
    value = float(value)
    return value if np.isfinite(value) else None
