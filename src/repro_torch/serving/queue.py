"""Request intake for continuous-batching serving.

Clients ``submit(SampleRequest, key=EngineKey(...))`` and get a
:class:`Ticket` back — a thread-safe future that resolves to the request's
:class:`~repro_torch.sampling.SampleResult` once a dispatch containing it is
collected.  The queue itself never touches engines: it only buckets tickets
per :class:`EngineKey` so the batcher can drain each bucket into fixed-slot
engine dispatches.

Ordering within a key is (priority desc, submission order): both live ON the
request (``SampleRequest.priority`` / ``SampleRequest.arrival_time``), so no
side-channel state keyed by request identity exists anywhere in the serving
layer.  ``submit`` stamps ``arrival_time`` with the queue clock when the
caller left it unset; simulators may pre-stamp it to replay a trace.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs import Observability
from repro_torch.sampling.types import SampleRequest, SampleResult


@dataclasses.dataclass(frozen=True, order=True)
class EngineKey:
    """Routing key: one engine per key.

    Requests under the same key share (architecture, step count T, solver),
    which is exactly the configuration one :class:`~repro_torch.sampling
    .SamplingEngine` owns; everything else (label, seed, warm start,
    priority) is per-lane data to its solve.
    """
    arch: str
    T: int
    solver: str

    def describe(self) -> str:
        return f"{self.arch}/T{self.T}/{self.solver}"


class Ticket:
    """Future for one submitted request (thread-safe), with an optional
    DRAFT stage for two-tier draft-and-refine serving.

    ``result()`` blocks until a serving loop collects the dispatch carrying
    the request (or fails it); ``latency_s`` is completion time minus the
    request's ``arrival_time``, on the queue's clock.

    Two-tier tickets (``repro_torch.serving.refine``): when the request
    early-exits at its ``quality_steps`` budget and a RefinePlanner takes
    the result as a draft, the DRAFT stage resolves immediately —
    ``draft_result()`` unblocks (and ``on_draft``, when set before
    submission, fires on the serving thread) — while the ticket stays open
    for the warm-started refinement that later resolves ``result()``.
    Single-stage tickets resolve both stages at once, so
    ``draft_result()`` never hangs on a request that was never drafted.
    """

    def __init__(self, key: EngineKey, request: SampleRequest, seqno: int,
                 clock: Callable[[], float]):
        self.key = key
        self.request = request
        self.seqno = seqno
        self.completed_time: Optional[float] = None
        self.draft_time: Optional[float] = None
        self.refines = 0                 # refine rounds already planned
        #: per-round convergence telemetry, attached at resolution by
        #: :class:`repro_torch.obs.ConvergenceRecorder` (stepwise serving with an
        #: active Observability); None otherwise
        self.residual_curve: Optional[List[Dict]] = None
        self.on_draft: Optional[Callable[[SampleResult], None]] = None
        self._clock = clock
        self._event = threading.Event()
        self._draft_event = threading.Event()
        self._result: Optional[SampleResult] = None
        self._draft: Optional[SampleResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def draft_done(self) -> bool:
        return self._draft_event.is_set()

    def result(self, timeout: Optional[float] = None) -> SampleResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.key.describe()}#{self.seqno} not served "
                f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def draft_result(self, timeout: Optional[float] = None) -> SampleResult:
        """The draft-stage result — the early-exited iterate a refine tier
        took as stage one, or the final result itself for a ticket that
        never drafted.  Blocks until the draft stage resolves."""
        if not self._draft_event.wait(timeout):
            raise TimeoutError(
                f"request {self.key.describe()}#{self.seqno} draft not "
                f"served within {timeout}s")
        if self._draft is not None:
            return self._draft
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        """Queue-clock latency (arrival -> completion); None while pending.
        For a two-tier ticket this spans the request's WHOLE life — the
        refine continuation keeps the original arrival time."""
        if self.completed_time is None or self.request.arrival_time is None:
            return None
        return self.completed_time - self.request.arrival_time

    @property
    def draft_latency_s(self) -> Optional[float]:
        """Arrival -> draft-stage latency (the interactive-tier number)."""
        if self.draft_time is None or self.request.arrival_time is None:
            return None
        return self.draft_time - self.request.arrival_time

    # resolution (serving-loop side) -----------------------------------------

    def resolve_draft(self, result: SampleResult) -> None:
        """Resolve the DRAFT stage only; the ticket stays open for the
        refined result."""
        self._draft = result
        self.draft_time = self._clock()
        callback = self.on_draft
        if callback is not None:
            try:
                callback(result)
            except Exception:  # noqa: BLE001 — a client callback must not
                pass           # kill the serving loop
        self._draft_event.set()

    def resolve(self, result: SampleResult) -> None:
        self._result = result
        self.completed_time = self._clock()
        if not self._draft_event.is_set():
            # single-stage ticket: the final result IS the draft stage
            self.draft_time = self.completed_time
            callback = self.on_draft
            if callback is not None:
                try:
                    callback(result)
                except Exception:  # noqa: BLE001
                    pass
            self._draft_event.set()
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self.completed_time = self._clock()
        self._event.set()
        # a draft that already resolved stays deliverable; otherwise the
        # draft stage fails with the ticket
        self._draft_event.set()


class RequestQueue:
    """Thread-safe, multi-key request queue.

    clock: timestamp source for arrival stamping and latency accounting
           (``time.monotonic`` by default; tests inject a fake clock to
           exercise deadline policies deterministically).
    validate: optional ``(request, key) -> None`` hook run at submit time
           (AFTER warm-start population) — a raise fails THAT ticket with
           the error instead of enqueueing it, so a malformed warm start
           never reaches a packed dispatch (see
           ``EngineRegistry.validate_submit``).
    warm_start: optional ``(request, key) -> Optional[WarmStart]`` hook —
           when set and the request carries no ``init``, its return value
           (if any) is spliced in at submit time.  This is the Sec 4.2
           cache auto-population point (``EngineRegistry.warm_start_for``).
    obs:   optional :class:`repro_torch.obs.Observability` — submissions count
           into its metrics registry and each ticket's lifecycle span opens
           on its tracer at submit time (the loop closes it at resolve).
           Wire the SAME bundle into the :class:`~repro_torch.serving
           .ServingLoop` for one coherent trace; without it the loop's
           admit-time fallback still opens the span (backdated to arrival).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 validate: Optional[Callable] = None,
                 warm_start: Optional[Callable] = None,
                 obs: Optional[Observability] = None):
        self.clock = clock
        self.validate = validate
        self.warm_start = warm_start
        self.obs = obs if obs is not None else Observability.off()
        self._lock = threading.Lock()
        self._buckets: Dict[EngineKey, List[Ticket]] = {}
        self._seq = itertools.count()
        self._closed: Optional[BaseException] = None

    @staticmethod
    def _order(ticket: Ticket):
        # (priority desc, seqno asc): FIFO-fair among equal priorities;
        # the sort key is immutable while enqueued, so one insertion
        # keeps the bucket ordered
        return (-ticket.request.priority, ticket.seqno)

    def submit(self, request: SampleRequest, key: EngineKey) -> Ticket:
        """Enqueue one request under ``key``; returns its Ticket future.

        On a closed queue (the serving loop died — see
        ``ServingLoop._abort``) the ticket comes back already failed with
        the loop's error, so clients surface it immediately instead of
        blocking out their ``result`` timeout on a request nobody will
        ever serve.  A ``validate``/``warm_start`` hook failure likewise
        fails only the returned ticket — never the submitting thread or
        the queue."""
        if request.arrival_time is None:
            request = dataclasses.replace(request,
                                          arrival_time=self.clock())
        with self._lock:
            ticket = Ticket(key, request, next(self._seq), self.clock)
            if self._closed is not None:
                ticket.fail(self._closed)
                return ticket
        tracer = self.obs.tracer
        tracer.async_begin("ticket", ticket.seqno, key=key.describe(),
                           ts_s=request.arrival_time,
                           label=request.label, seed=request.seed)
        self.obs.metrics.counter("queue.submitted").inc(key=key.describe())
        try:
            if self.warm_start is not None and request.init is None:
                init = self.warm_start(request, key)
                if init is not None:
                    request = dataclasses.replace(request, init=init)
                    ticket.request = request
                    tracer.async_instant("warm_start", ticket.seqno,
                                         t_init=init.t_init)
            if self.validate is not None:
                self.validate(request, key)
            tracer.async_instant("validate", ticket.seqno)
        except Exception as error:  # noqa: BLE001 — fail the one ticket
            self.obs.metrics.counter(
                "queue.rejected").inc(key=key.describe())
            tracer.async_end("ticket", ticket.seqno, error=str(error))
            ticket.fail(error)
            return ticket
        return self._enqueue(ticket)

    def resubmit(self, ticket: Ticket,
                 request: Optional[SampleRequest] = None) -> Ticket:
        """Re-enqueue an OPEN ticket — the refine tier's continuation path:
        the ticket keeps its identity (draft future, seqno, original
        ``arrival_time``) while ``request`` (when given) replaces what the
        next dispatch will run.  Also the preemption path: a vacated
        preemptible lane's ticket re-enters the queue with its warm-started
        request intact."""
        if ticket.done():
            raise ValueError(
                f"ticket {ticket.key.describe()}#{ticket.seqno} already "
                f"resolved; cannot resubmit")
        if request is not None:
            ticket.request = request
        self.obs.metrics.counter(
            "queue.resubmitted").inc(key=ticket.key.describe())
        self.obs.tracer.async_instant("resubmit", ticket.seqno,
                                      refines=ticket.refines)
        return self._enqueue(ticket)

    def _enqueue(self, ticket: Ticket) -> Ticket:
        with self._lock:
            if self._closed is not None:
                ticket.fail(self._closed)
                return ticket
            bisect.insort(self._buckets.setdefault(ticket.key, []), ticket,
                          key=self._order)
        return ticket

    def close(self, error: BaseException) -> None:
        """Mark the queue dead: every future submit fails with ``error``."""
        with self._lock:
            self._closed = error

    def pop(self, key: EngineKey, n: int, *,
            promote_before: Optional[float] = None) -> List[Ticket]:
        """Dequeue up to ``n`` tickets for ``key`` in dispatch order.

        ``promote_before``: arrival-time cutoff for deadline promotion —
        tickets that have waited past the batching deadline jump the
        priority order (oldest first).  Without it, sustained high-priority
        traffic could starve an old low-priority request forever: every
        deadline-triggered dispatch would fill with newer, higher-priority
        tickets and never include the one whose deadline fired.
        Preemptible (background/refine) tickets never deadline-promote:
        they keep the original request's arrival time, which is NOT a
        service deadline for the background tier.
        """
        with self._lock:
            bucket = self._buckets.get(key, [])
            if promote_before is not None:
                bucket = sorted(bucket, key=lambda t: (
                    t.request.preemptible
                    or t.request.arrival_time > promote_before,
                    -t.request.priority, t.seqno))
            taken, rest = bucket[:n], bucket[n:]
            if rest:
                # restore the submit order invariant (priority desc, seqno)
                rest.sort(key=self._order)
                self._buckets[key] = rest
            else:
                self._buckets.pop(key, None)
        return taken

    def sweep_expired(self, now: Optional[float] = None) -> List[Ticket]:
        """Pop every QUEUED ticket whose request carries a ``timeout_s``
        that has elapsed (queue clock) and return them — without failing
        them: the caller (``ServingLoop.pump``) funnels each through its
        ``_fail_ticket`` path with a ``TimeoutError`` so spans close and
        loop counters stay coherent.  Tickets already admitted to a lane
        are not the queue's to expire; once dispatched, a request runs to
        completion (its ticket resolves normally) or fails with its bank."""
        if now is None:
            now = self.clock()
        expired: List[Ticket] = []
        with self._lock:
            for key in list(self._buckets):
                bucket = self._buckets[key]
                keep = []
                for t in bucket:
                    r = t.request
                    if (r.timeout_s is not None
                            and r.arrival_time is not None
                            and now - r.arrival_time > r.timeout_s):
                        expired.append(t)
                    else:
                        keep.append(t)
                if len(keep) != len(bucket):
                    if keep:
                        self._buckets[key] = keep
                    else:
                        del self._buckets[key]
        return expired

    def pending(self, key: EngineKey) -> int:
        with self._lock:
            return len(self._buckets.get(key, ()))

    def pending_urgent(self, key: EngineKey) -> int:
        """Pending NON-preemptible tickets — the fresh-arrival demand the
        loop sizes its admission (and refine-lane preemption) against."""
        with self._lock:
            return sum(not t.request.preemptible
                       for t in self._buckets.get(key, ()))

    def keys(self) -> List[EngineKey]:
        """Keys with at least one pending ticket."""
        with self._lock:
            return list(self._buckets)

    def oldest_arrival(self, key: EngineKey) -> Optional[float]:
        """Earliest ``arrival_time`` pending under ``key`` (deadline input)."""
        with self._lock:
            bucket = self._buckets.get(key)
            if not bucket:
                return None
            return min(t.request.arrival_time for t in bucket)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buckets.values())
