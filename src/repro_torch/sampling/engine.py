"""SamplingEngine: batched execution of SampleRequests on one device.

The engine owns (denoiser apply fn, params, solver coefficients, sampler
spec, sample shape, device) and runs whole batches of requests through the
ParaTAA solver with the requests as its lane axis, so every solver
iteration evaluates the denoiser on a single (requests x window) batch and
every Anderson update is one kernel launch for all lanes.

Per-request labels, seeds, warm starts (Sec 4.2) and solver budgets are
per-lane data.  Batches are padded to a fixed slot count by repeating the
last request (padding discarded at ``collect``).  ``run_batch`` is the
blocking path; its halves ``dispatch`` (pack + solve) and ``collect``
(wait for the device, fetch, account) are public.

Noise comes from ``noise_fn(request) -> (T+1, *sample_shape)``, by default
:func:`repro_torch.diffusion.samplers.draw_noises` seeded from
``request.seed``; tests inject the JAX package's noise through it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import parataa as _parataa
from repro_torch.core.coeffs import SolverCoeffs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion.samplers import _sequential_sample, draw_noises
from repro_torch.sampling.specs import SamplerSpec
from repro_torch.sampling.types import DIAG_KEYS, SampleRequest, SampleResult


@dataclasses.dataclass
class PendingBatch:
    """One dispatch whose outputs may still be in flight on the device."""
    trajs: torch.Tensor
    info: Dict[str, torch.Tensor]
    requests: List[SampleRequest]   # the real (unpadded) requests
    slots: int                      # padded request-slot count dispatched
    diagnostics: bool
    pack_s: float                   # host-side packing / noise wall time
    t_dispatch: float               # clock reading when the solve started
    polls: int = 0                  # host reads the solve made (its polls)


class SamplingEngine:
    """Batched sampling executor for one (denoiser, T, solver) configuration.

    eps_apply:    (params, x (n, *sample_shape), taus (n,), labels (n,)) -> eps
    params:       denoiser parameters, passed through to ``eps_apply``
    coeffs:       SolverCoeffs (fixes T and the DDIM/DDPM schedule)
    spec:         SamplerSpec strategy ("seq" or any ParaTAA variant)
    sample_shape: per-sample latent shape, e.g. (num_tokens, latent_dim)
    device:       where the solve runs; None = cuda (raises without CUDA)
    noise_fn:     request -> (T+1, *sample_shape) noise; default draws from
                  a torch.Generator seeded with ``request.seed``
    clock:        monotonic timestamp source for ``wall_s``/``pack_s``
    """

    #: ``last_dispatches`` cap
    MAX_DISPATCH_REPORTS = 256

    def __init__(self, eps_apply: Callable, params, coeffs: SolverCoeffs,
                 spec: SamplerSpec, *, sample_shape: Sequence[int],
                 dtype=torch.float32, device: DeviceLike = None,
                 noise_fn: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.eps_apply = eps_apply
        self.params = params
        self.coeffs = coeffs
        self.spec = spec
        self.sample_shape = tuple(sample_shape)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.noise_fn = noise_fn or self.draw_request_noise
        self._clock = clock
        self.stats = {"batches": 0, "requests": 0, "wall_s": 0.0,
                      "pack_s": 0.0, "host_fetch_bytes": 0,
                      "blocking_polls": 0, "update_launches": 0}
        self.last_dispatches: List[Dict] = []

    @property
    def window(self) -> int:
        """eps evaluations per solver iteration per lane (1 for seq)."""
        T = self.coeffs.T
        if self.spec.is_sequential:
            return 1
        return min(self.spec.window or T, T)

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
        (B,) f32."""
        T = self.coeffs.T
        dev = self.device
        xis, x0s, labels, t_inits, tau_sqs, iter_caps = [], [], [], [], [], []
        for req in requests:
            xi = torch.as_tensor(self.noise_fn(req), dtype=torch.float32)
            xi = xi.to(dev).reshape((T + 1,) + self.sample_shape)
            xis.append(xi)
            labels.append(req.label)
            tau_sqs.append(float(self.spec.request_tau_sq(req)))
            iter_caps.append(self.spec.request_iter_cap(req, T))
            if req.init is None:
                x0s.append(xi)          # cold start: noise-initialized
                t_inits.append(T)
            else:
                # warm starts pack as f32 whatever precision they were
                # recorded in; t_init None => full restart, 0 => verify only
                init = req.init.trajectory
                init = init.float() if isinstance(init, torch.Tensor) \
                    else torch.from_numpy(np.asarray(init, np.float32))
                x0s.append(init.to(dev).reshape(xi.shape))
                t_inits.append(T if req.init.t_init is None
                               else req.init.t_init)

        def ints(v):
            return torch.as_tensor(v, dtype=torch.long, device=dev)

        return (torch.stack(xis), ints(labels), torch.stack(x0s),
                ints(t_inits),
                torch.as_tensor(tau_sqs, dtype=torch.float32, device=dev),
                ints(iter_caps))

    # -- execution -----------------------------------------------------------

    def _solve(self, xis, labels, x0s, t_inits, tau_sqs, iter_caps,
               diagnostics: bool):
        coeffs, spec = self.coeffs, self.spec
        T = coeffs.T
        B = xis.shape[0]

        def eps_fn(xw, taus):
            # xw holds every lane's window, lane-major: B * w samples
            w = xw.shape[0] // B
            y = labels[:, None].expand(B, w).reshape(B * w)
            return self.eps_apply(self.params, xw, taus, y)

        if spec.is_sequential:
            traj = _sequential_sample(eps_fn, coeffs, xis, return_traj=True)
            full = torch.full((B,), T, dtype=torch.long, device=xis.device)
            return traj, dict(iters=full, nfe=full.clone(),
                              converged=torch.ones_like(full,
                                                        dtype=torch.bool)), 0
        solver = spec.solver_config(T)
        fn = _parataa.sample_recording if diagnostics else _parataa.sample
        traj, info = fn(eps_fn, coeffs, solver, xis, x_init=x0s,
                        dtype=self.dtype, t_init=t_inits, tau_sq=tau_sqs,
                        iter_cap=iter_caps)
        keep = ("iters", "nfe", "converged", "residuals") + \
            (DIAG_KEYS if diagnostics else ())
        return traj, {k: info[k] for k in keep if k in info}, \
            info.get("polls", 0)

    def run(self, request: SampleRequest, **kw) -> SampleResult:
        return self.run_batch([request], **kw)[0]

    def dispatch(self, requests: Sequence[SampleRequest], *,
                 slots: Optional[int] = None,
                 diagnostics: bool = False) -> PendingBatch:
        """Pack ``requests`` and solve them as ONE lane batch, padded to
        ``slots`` lanes (default: the request count) by repeating the last
        request.  The host loop polls whether every lane has finished once
        per iteration (``parataa.poll_finished``, its only wait on the
        card), so this returns once the solve's last kernels are queued;
        ``collect`` waits for them."""
        requests = list(requests)
        if not requests:
            raise ValueError("dispatch needs at least one request")
        self.spec.check_request_flags(
            diagnostics=diagnostics,
            warm_start=any(r.init is not None for r in requests),
            solver_overrides=any(r.has_solver_overrides for r in requests))
        B = slots or len(requests)
        if len(requests) > B:
            raise ValueError(
                f"{len(requests)} requests exceed {B} request slots")
        chunk = requests + [requests[-1]] * (B - len(requests))
        t0 = self._clock()
        packed = self._pack(chunk)
        t1 = self._clock()
        with torch.inference_mode():
            trajs, info, polls = self._solve(*packed,
                                             diagnostics=diagnostics)
        return PendingBatch(trajs=trajs, info=info, requests=requests,
                            slots=B, diagnostics=diagnostics,
                            pack_s=t1 - t0, t_dispatch=t1, polls=polls)

    def collect(self, pending: PendingBatch) -> List[SampleResult]:
        """Wait for one dispatch, record its stats, unpack its results.

        ``wall_s`` spans solve start -> outputs ready on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
            slot_utilization=n_real / pending.slots,
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
        B = batch_size or len(requests)
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

    def throughput(self) -> float:
        """Requests per second over every batch this engine has run."""
        return self.stats["requests"] / max(self.stats["wall_s"], 1e-9)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy (bf16, which numpy lacks, as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _finite_or_none(value) -> Optional[float]:
    """+inf (a lane that never produced a first-order residual) -> None."""
    value = float(value)
    return value if np.isfinite(value) else None
