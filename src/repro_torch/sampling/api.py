"""Functional single-request entry point of the sampling API.

``run(spec, eps_fn, coeffs, xi)`` executes one sampling request with any
registered strategy — sequential DDIM/DDPM or any ParaTAA variant — and
returns a typed :class:`SampleResult`.  For batched serving use
:class:`repro_torch.sampling.SamplingEngine`, which runs the same solver
over a lane axis.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import parataa as _parataa
from repro_torch.core.coeffs import SolverCoeffs
from repro_torch.diffusion.samplers import _sequential_sample
from repro_torch.sampling.specs import SamplerSpec
from repro_torch.sampling.types import (DIAG_KEYS, SampleRequest,
                                        SampleResult, WarmStart)


def sequential_sample(eps_fn: Callable, coeffs: SolverCoeffs, xi, *,
                      return_traj: bool = False):
    """The eq. (6) reference sampler for one request: T sequential eps
    evaluations (the JAX package's signature).

    eps_fn: (x (1, *shape), taus (1,)) -> eps (1, *shape)
    xi:     (T+1, *shape) noises (xi[T] = x_T); its device is where it runs
    Returns x_0 (*shape), or the full trajectory (T+1, *shape).
    """
    return _sequential_sample(eps_fn, coeffs, xi[None],
                              return_traj=return_traj)[0]


def run(spec: SamplerSpec, eps_fn: Callable, coeffs: SolverCoeffs, xi, *,
        init: Optional[WarmStart] = None, diagnostics: bool = False,
        request: Optional[SampleRequest] = None,
        dtype=torch.float32) -> SampleResult:
    """Execute one sampling request (one lane).

    eps_fn: (x (n, *shape), taus (n,)) -> eps (n, *shape)
    xi:     (T+1, *shape) noise draws (xi[T] = x_T), e.g. from draw_noises;
            its device is where the request runs
    init:   optional WarmStart (trajectory + restart depth T_init)
    diagnostics: record per-iteration residuals / x0 iterates
    """
    T = coeffs.T
    overrides = request is not None and request.has_solver_overrides
    spec.check_request_flags(diagnostics=diagnostics,
                             warm_start=init is not None,
                             solver_overrides=overrides)
    if spec.is_sequential:
        traj = sequential_sample(eps_fn, coeffs, xi, return_traj=True)
        return SampleResult(x0=traj[0], trajectory=traj, iters=T, nfe=T,
                            converged=True, request=request)
    xi = xi[None]

    solver = spec.solver_config(T)
    x_init = t_init = None
    if init is not None:
        x_init = torch.as_tensor(init.trajectory, device=xi.device)[None]
        t_init = init.t_init  # None => full restart (T); 0 => fully solved
    tau_sq = iter_cap = None
    if overrides:
        tau_sq = float(spec.request_tau_sq(request))
        iter_cap = spec.request_iter_cap(request, T)
    fn = _parataa.sample_recording if diagnostics else _parataa.sample
    traj, info = fn(eps_fn, coeffs, solver, xi, x_init=x_init, dtype=dtype,
                    t_init=t_init, tau_sq=tau_sq, iter_cap=iter_cap)
    traj = traj[0]
    diag = {k: info[k][0] for k in DIAG_KEYS} if diagnostics else None
    iters, converged = int(info["iters"][0]), bool(info["converged"][0])
    return SampleResult(x0=traj[0], trajectory=traj, iters=iters,
                        nfe=int(info["nfe"][0]), converged=converged,
                        early_stopped=request is not None
                        and spec.request_early_stopped(request, T, iters,
                                                       converged),
                        residuals=None if diagnostics
                        else info["residuals"][0],
                        diagnostics=diag, request=request)
