"""Two-tier draft-and-refine serving (DRiffusion / Self-Refining Samplers).

A draft-tier request carries a ``quality_steps`` budget (Sec 4.1): the
solver returns a usable iterate after a few fixed-point iterations instead
of running to full tolerance.  Refinement is nothing but MORE fixed-point
iterations from that better init — the solver is reused verbatim — so the
refine tier is pure scheduling:

  * when a draft early-exits, its :class:`~repro_torch.serving.Ticket` resolves
    the DRAFT stage immediately (``draft_result()`` / ``on_draft``) and
    stays open;
  * the :class:`RefinePlanner` re-enqueues a warm-started continuation
    (``init = draft.warm_start(t_init)``, full tolerance, background
    priority, ``preemptible=True``) on the SAME ticket, keeping the
    original ``arrival_time`` so final latency spans the request's whole
    life;
  * the continuation splices back into the live
    :class:`~repro_torch.sampling.engine.LaneBank` like any refill — no
    new stepwise program kind — but the
    :class:`~repro_torch.serving.ServingLoop` treats its lane as preemptible:
    refine lanes fill otherwise-wasted slots and are vacated (and
    re-enqueued, warm state intact) the moment fresh draft-tier arrivals
    need them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.sampling.types import SampleResult
from repro_torch.serving.queue import RequestQueue, Ticket


@dataclasses.dataclass(frozen=True)
class RefinePolicy:
    """Knobs of the refine tier.

    t_init:      restart depth of the continuation's warm start (``None`` =
                 full restart from the draft trajectory — every row active,
                 the draft is the initial iterate).
    priority:    continuation priority; negative (default -1) ranks refines
                 below every default-priority fresh arrival.
    tau:         tolerance override for the refined solve (``None`` = the
                 engine spec's full tolerance).
    max_refines: refine rounds per ticket (1 = draft + one refinement).
    """
    t_init: Optional[int] = None
    priority: int = -1
    tau: Optional[float] = None
    max_refines: int = 1

    def __post_init__(self):
        if self.max_refines < 1:
            raise ValueError(
                f"max_refines must be >= 1, got {self.max_refines}")


class RefinePlanner:
    """Turns early-exited drafts into warm-started background continuations.

    Stateless beyond its policy: the two-stage bookkeeping lives on the
    :class:`Ticket` (``refines`` counter, draft future), the queue carries
    the continuation, and the loop's lane table carries preemption state —
    so the planner composes with any loop/batcher configuration.
    """

    def __init__(self, policy: Optional[RefinePolicy] = None, *,
                 metrics=None):
        self.policy = policy or RefinePolicy()
        #: optional :class:`repro_torch.obs.MetricsRegistry` — drafts taken and
        #: draft-stage latency feed ``refine.*`` instruments
        self.metrics = metrics

    def plan(self, queue: RequestQueue, ticket: Ticket,
             result: SampleResult) -> bool:
        """Consume one harvested result.  Returns True when the result was
        taken as a DRAFT (stage one resolved, a refine continuation
        re-enqueued on the same ticket); False means the result is final
        and the caller should resolve the ticket outright."""
        if not result.early_stopped or ticket.refines >= \
                self.policy.max_refines:
            return False
        ticket.resolve_draft(result)
        ticket.refines += 1
        if self.metrics is not None:
            self.metrics.counter("refine.drafts").inc(
                key=ticket.key.describe())
            wait = ticket.draft_latency_s
            if wait is not None:
                self.metrics.histogram("refine.draft_latency_s").observe(
                    wait, key=ticket.key.describe())
        continuation = dataclasses.replace(
            result.request or ticket.request,
            init=result.warm_start(self.policy.t_init),
            tau=self.policy.tau, max_iters=None, quality_steps=None,
            priority=self.policy.priority, preemptible=True)
        queue.resubmit(ticket, continuation)
        return True
