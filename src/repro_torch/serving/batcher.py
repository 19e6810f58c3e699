"""Batching policy: drain a RequestQueue into fixed-slot engine dispatches.

Every key dispatches at ONE slot geometry — the policy's ``max_batch``
lanes — so every dispatch of a key has the same shapes no matter how full
it is (padding lanes repeat a request).  Within that fixed geometry the
policy decides WHEN a bucket is worth dispatching:

  * fill:      pending >= ``target_util`` of the slot count — the dispatch
               is full enough to be slot-efficient;
  * deadline:  the oldest pending request has waited ``max_wait_s`` — never
               hold a request hostage to utilization;
  * idle:      the loop reports the device pipeline empty and the policy is
               work-conserving — a partial dispatch now beats an idle device
               (continuous batching's latency win);
  * flush:     the caller is draining (shutdown / end of trace).

Warm- and cold-start requests mix freely inside one dispatch: a warm start
is per-lane data to the same solve, not a different one.  The batcher also
folds the engine's own ``last_dispatches`` reports (via :meth:`Batcher.note`)
into per-key observed slot-utilization / wall statistics, which `serve.py`
reports and operators tune ``max_batch`` / ``max_wait_s`` against.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serving.queue import EngineKey, RequestQueue, Ticket
from repro_torch.serving.registry import EngineRegistry


@dataclasses.dataclass(frozen=True)
class BatchingPolicy:
    """Knobs of the drain policy.

    max_batch:       request slots per dispatch (the FIXED geometry).
    max_wait_s:      oldest-request deadline before a partial dispatch.
    target_util:     slot-utilization fraction that makes a dispatch "full
                     enough" before the deadline.
    work_conserving: dispatch partial batches immediately while the device
                     pipeline is idle (set False to always hold for
                     fill/deadline, trading latency for utilization).
    """
    max_batch: int = 8
    max_wait_s: float = 0.05
    target_util: float = 1.0
    work_conserving: bool = True

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if not 0.0 < self.target_util <= 1.0:
            raise ValueError(
                f"target_util must be in (0, 1], got {self.target_util}")
        if self.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {self.max_wait_s}")


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """One planned engine dispatch: tickets in dispatch order + geometry."""
    key: EngineKey
    tickets: Tuple[Ticket, ...]
    slots: int


class Batcher:
    """Stateful drain policy over a :class:`RequestQueue`."""

    #: per-key history window of observed dispatch reports
    OBSERVED_WINDOW = 32

    def __init__(self, policy: Optional[BatchingPolicy] = None, *,
                 metrics=None):
        self.policy = policy or BatchingPolicy()
        #: optional :class:`repro_torch.obs.MetricsRegistry` — planned dispatches
        #: and observed per-dispatch walls feed ``batcher.*`` instruments
        self.metrics = metrics
        self._observed: Dict[EngineKey, Deque[dict]] = {}

    def slots_for(self, engine) -> int:
        """The key's fixed dispatch geometry: the policy's ``max_batch``,
        rounded up to a multiple of the engine placement's data shards."""
        placement = getattr(engine, "placement", None)
        if placement is None:
            return self.policy.max_batch
        return placement.round_batch(self.policy.max_batch)

    def fill_quota(self, slots: int) -> int:
        return max(1, math.ceil(self.policy.target_util * slots))

    def plan(self, queue: RequestQueue, registry: EngineRegistry, *,
             now: Optional[float] = None, flush: bool = False,
             idle: bool = False) -> List[Dispatch]:
        """Pop every dispatch the policy considers ready, most-starved key
        first.  ``idle`` is the loop's "device pipeline is empty" signal;
        ``flush`` drains unconditionally."""
        if now is None:
            now = time.monotonic()
        plans: List[Dispatch] = []

        def starvation(key):
            oldest = queue.oldest_arrival(key)
            # explicit None check: 0.0 is a legitimate (trace) arrival time
            return (now if oldest is None else oldest, key)

        keys = sorted(queue.keys(), key=starvation)
        for key in keys:
            try:
                engine = registry.get(key)
            except Exception as error:  # noqa: BLE001 — poisoned key: the
                # engine factory failed (bad solver, out of memory for the
                # params); fail ITS tickets, keep serving others
                for ticket in queue.pop(key, queue.pending(key)):
                    ticket.fail(error)
                continue
            slots = self.slots_for(engine)
            quota = self.fill_quota(slots)
            while True:
                n = queue.pending(key)
                if n == 0:
                    break
                ready = flush or n >= quota \
                    or (idle and self.policy.work_conserving)
                if not ready:
                    oldest = queue.oldest_arrival(key)
                    ready = oldest is not None \
                        and now - oldest >= self.policy.max_wait_s
                if not ready:
                    break
                tickets = tuple(queue.pop(
                    key, slots,
                    promote_before=now - self.policy.max_wait_s))
                plans.append(Dispatch(key=key, tickets=tickets, slots=slots))
                # the first planned dispatch fills the pipeline: stop
                # justifying partials by an idle device from here on
                idle = False
                # a full pop may leave a ready remainder; partials drain it
                if len(tickets) >= n:
                    break
        return plans

    # -- iteration-level admission (stepwise banks) --------------------------

    def plan_refill(self, queue: RequestQueue, key: EngineKey,
                    free_slots: int, *, now: float, active: bool,
                    flush: bool = False) -> List[Ticket]:
        """Pop the tickets to admit into the free lanes of a live
        :class:`~repro_torch.sampling.engine.LaneBank` this round.

        The work-conserving drain counts IN-FLIGHT REFILLABLE SLOTS, not
        just an idle device pipeline: when the bank has active lanes
        (``active``) the chunk runs with or without newcomers, so admitting
        them immediately is free work — no fill-or-deadline wait.  Only a
        fully idle bank (a cold start, where admission is what lights up
        the device) applies the usual fill / deadline / flush gate.

        ``free_slots`` is the caller's ADMITTABLE capacity, not raw lane
        vacancy: preemptible (refine-tier) lanes are background occupancy,
        so the loop adds as many of them as urgent pending demand requires
        (``ServingLoop._pump_stepwise``) — the fill-or-deadline occupancy
        count never lets background refinement starve fresh-arrival
        admission.
        """
        if free_slots <= 0 or queue.pending(key) == 0:
            return []
        ready = flush or (self.policy.work_conserving and active) \
            or queue.pending(key) >= self.fill_quota(free_slots)
        if not ready:
            oldest = queue.oldest_arrival(key)
            ready = oldest is not None \
                and now - oldest >= self.policy.max_wait_s
        if not ready:
            return []
        return queue.pop(key, free_slots,
                         promote_before=now - self.policy.max_wait_s)

    # -- observed-dispatch feedback ------------------------------------------

    def note(self, key: EngineKey, report: dict) -> None:
        """Fold one ``engine.last_dispatches`` entry into the key's stats."""
        window = self._observed.setdefault(
            key, collections.deque(maxlen=self.OBSERVED_WINDOW))
        window.append(report)
        if self.metrics is not None and "wall_s" in report:
            self.metrics.histogram("batcher.dispatch_wall_s").observe(
                report["wall_s"], key=key.describe())

    def observed(self, key: EngineKey) -> Optional[dict]:
        """Mean utilization / wall / pack over the key's recent dispatches."""
        window = self._observed.get(key)
        if not window:
            return None
        n = len(window)
        return dict(
            dispatches=n,
            slot_utilization=sum(d["slot_utilization"] for d in window) / n,
            wall_s=sum(d["wall_s"] for d in window) / n,
            pack_s=sum(d["pack_s"] for d in window) / n)
