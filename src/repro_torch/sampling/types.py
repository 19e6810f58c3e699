"""Typed request/result surface of the unified sampling API.

A ``SampleRequest`` is everything the serving layer knows about one sample:
conditioning label, RNG seed, and an optional warm start (Sec 4.2 trajectory
initialization).  A ``SampleResult`` is everything a caller may want back:
the x0 latent, the full trajectory, solver statistics, and (when requested)
per-iteration diagnostics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

#: per-iteration recordings produced by a diagnostics=True run, in the order
#: they appear in SampleResult.diagnostics (single source for api + engine)
DIAG_KEYS = ("res_history", "x0_history", "t2_history", "done_history")


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """Trajectory initialization (paper Sec 4.2): start the solver from a
    previously solved trajectory of a similar condition.

    trajectory: (T+1, *sample_shape) solved trajectory to initialize from.
    t_init:     restart depth T_init — rows above t_init are treated as
                already-converged.  ``None`` (default) means "full restart":
                the trajectory is only used as the initial iterate, all T
                rows active.  An explicit ``0`` is the opposite extreme — a
                fully-solved trajectory whose convergence the solver only
                verifies (one window pass).
    """
    trajectory: Any
    t_init: Optional[int] = None

    @classmethod
    def from_result(cls, result: "SampleResult",
                    t_init: Optional[int] = None) -> "WarmStart":
        """Warm-start from a solved :class:`SampleResult` — the handle the
        Sec 4.2 trajectory cache hands back to similar requests."""
        return cls(trajectory=result.trajectory, t_init=t_init)


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    """One sampling request: (conditioning, seed, optional warm start,
    optional per-request solver budget).

    ``arrival_time``, ``priority``, and ``preemptible`` are serving
    metadata carried on the request itself so batching layers never need a
    side-channel dict keyed by request identity: the engine ignores all
    three.  ``arrival_time`` is the queue clock reading at submission;
    ``priority`` orders requests within one engine key — higher dispatches
    first, FIFO among equals.  ``preemptible`` marks a background-tier
    request (e.g. a draft-and-refine continuation): its lane fills
    otherwise-wasted slots and may be vacated mid-solve when fresh
    non-preemptible arrivals need the slot.  (The serving layer that reads
    them is not ported yet.)

    ``tau`` / ``max_iters`` / ``quality_steps`` are per-request SOLVER
    overrides, packed as per-lane tensors into one dispatch (they are
    data, like labels):

    tau:           stopping tolerance override (default: the engine spec's
                   tau).  A looser tau retires the request earlier.
    max_iters:     hard per-request iteration budget (result reports
                   ``converged=False``/``early_stopped=True`` when hit).
    quality_steps: Sec 4.1 early exit — return after this many solver
                   iterations, where iterates are already usable, instead
                   of running to full tolerance.
    """
    label: int = 0
    seed: int = 0
    init: Optional[WarmStart] = None
    arrival_time: Optional[float] = None
    priority: int = 0
    preemptible: bool = False
    tau: Optional[float] = None
    max_iters: Optional[int] = None
    quality_steps: Optional[int] = None
    #: serving metadata like the three above (the engine ignores it): when
    #: set, the queue's expiry sweep fails the ticket with ``TimeoutError``
    #: once ``timeout_s`` seconds pass after ``arrival_time`` without the
    #: request being admitted — a bounded wait instead of a hung
    #: ``result()``.  ``dataclasses.replace``-based continuations (refine,
    #: preemption resubmits) inherit it automatically.
    timeout_s: Optional[float] = None

    @property
    def has_solver_overrides(self) -> bool:
        return (self.tau is not None or self.max_iters is not None
                or self.quality_steps is not None)


@dataclasses.dataclass
class SampleResult:
    """Outcome of one request.

    x0:          the generated latent, shape ``sample_shape``.
    trajectory:  full (T+1, *sample_shape) trajectory.
    iters:       parallelizable solver iterations executed (== T for seq).
    nfe:         number of eps evaluations issued (== T for seq).
    converged:   solver reached its tolerance (always True for seq).
    early_stopped: the request exited at its own ``quality_steps`` /
                 ``max_iters`` budget before full tolerance (Sec 4.1) —
                 the iterate is the deliverable, not a failure.
    residuals:   final per-timestep first-order residuals (parallel only).
    diagnostics: per-iteration recordings (res_history, x0_history, ...)
                 when the run was issued with diagnostics=True.
    request:     the originating request (label/seed round-trip).
    wall_s:      caller-observed wall time of the batch the request ran in.
    """
    x0: Any
    trajectory: Any
    iters: int
    nfe: int
    converged: bool
    early_stopped: bool = False
    residuals: Optional[Any] = None
    diagnostics: Optional[Dict[str, Any]] = None
    request: Optional[SampleRequest] = None
    wall_s: float = 0.0

    def warm_start(self, t_init: Optional[int] = None) -> WarmStart:
        """This result's solved trajectory as a :class:`WarmStart` handle
        (Sec 4.2): ``engine.run(request.init=result.warm_start(t))``."""
        return WarmStart.from_result(self, t_init=t_init)

    @property
    def info(self) -> Dict[str, Any]:
        """Legacy-shaped info dict (the old ``sample`` second return value)."""
        d = dict(iters=self.iters, nfe=self.nfe, converged=self.converged,
                 residuals=self.residuals)
        if self.diagnostics:
            d.update(self.diagnostics)
        return d
