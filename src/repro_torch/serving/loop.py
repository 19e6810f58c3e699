"""Double-buffered dispatch loop: the pump between queue and engines.

The loop keeps up to ``depth`` engine dispatches in flight.
``SamplingEngine.dispatch`` returns once the solve's last iteration is
queued on the device (its host loop polls once per iteration, so it has
waited for the earlier ones), and ``collect`` waits on that dispatch's own
CUDA event, never on the whole device; the loop packs dispatch N+1 on the
host — per-request noise, stacking, pinned copies — while dispatch N's
last iteration computes, and collects whichever in-flight batch is ready
(``PendingBatch.ready()``).

With ``chunk_iters > 0`` the loop serves ITERATION-LEVEL rounds instead:
each round queues a chunk of solver iterations without waiting, and the
next round's one blocking poll per key finds out which lanes finished.

The loop can be driven two ways:

  * synchronously — ``pump()`` one scheduling round at a time, or
    ``drain()`` until queue and pipeline are empty (tests, benchmarks,
    closed-loop replay);
  * as a background thread — ``start()`` / ``stop()`` around client threads
    that ``queue.submit(...)`` and block on their tickets (live serving,
    the ``serve.py --serve-async`` entry point).

Under ``torch.distributed`` (engines on a mesh, one process per rank)
every rank runs the loop, and every rank must issue the same collectives
in the same order — but the queue, the batcher's fill deadlines and the
arrival clock are wall-clock decisions that ranks would take apart.  So
rank 0 decides each round (:class:`RankControl`): it alone holds the
queue and the tickets, and it broadcasts a round header (go on or stop),
then for each key the lanes to preempt and the requests to splice into
which lanes (stepwise), or the dispatches to run (whole batch).  The other
ranks execute exactly that; what an engine polls or harvests is already
replicated on every rank (it is all-gathered), so harvests agree without a
message.  At world size 1 ``RankControl`` is an identity: nothing is sent.
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Optional, Tuple

from repro_torch import comm
from repro_torch.obs import Observability, StatsView
from repro_torch.serving.batcher import Batcher, Dispatch
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.registry import EngineRegistry


class ShutdownError(RuntimeError):
    """The serving loop was stopped (``stop(drain=False)``) while tickets
    were still open: every stranded ticket fails with this instead of
    hanging its ``result()`` forever.  A draft stage that already resolved
    stays deliverable (``Ticket.fail`` keeps ``_draft``)."""


class RankControl:
    """Who decides a round: rank 0 (the leader) decides every host-side
    choice and :meth:`share` hands it to the other ranks, which pass None
    and take the leader's value.  At world size 1 ``share`` returns its
    argument and sends nothing."""

    def __init__(self):
        self.world = comm.world()
        self.rank = comm.rank()

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def share(self, obj, group=None):
        """The leader's ``obj`` on every rank of ``group`` (default: all)."""
        if self.world == 1:
            return obj
        return comm.broadcast_object(obj, src=0, group=group)


class ServingLoop:
    """Continuous-batching executor over an :class:`EngineRegistry`.

    registry: EngineKey -> engine resolution (lazily constructed).
    queue:    request intake; the loop is its only consumer.
    batcher:  drain policy (default :class:`Batcher` defaults).
    depth:    max dispatches in flight (1 = no overlap, 2 = double buffer).
    chunk_iters: 0 (default) = whole-batch mode — every dispatch runs to
              the convergence of its SLOWEST member before any ticket
              resolves.  > 0 = ITERATION-LEVEL continuous batching: each
              key keeps one live :class:`~repro_torch.sampling.engine.LaneBank`,
              the pump advances it ``chunk_iters`` solver iterations per
              round, lanes retire the moment their own request converges
              (or hits its per-request ``quality_steps``/``max_iters``
              budget — Sec 4.1 early exit), and freed lanes are refilled
              from the queue into the live solver state.
    refiner:  optional :class:`~repro_torch.serving.RefinePlanner` enabling the
              two-tier draft-and-refine path (stepwise mode only): a
              harvested result the planner takes as a DRAFT resolves the
              ticket's draft stage and re-enqueues a warm-started,
              preemptible continuation instead of completing.  Refine
              lanes are background occupancy — they fill otherwise-wasted
              slots, never gate admission, and are vacated (ticket
              re-enqueued, warm start intact) when fresh non-preemptible
              arrivals need their slot.
    cache:    record converged final results into the registry's per-key
              :class:`~repro_torch.serving.TrajectoryCache` at harvest/collect,
              so later submissions warm-start via the queue's
              ``warm_start`` hook (``EngineRegistry.warm_start_for``).
    obs:      optional :class:`repro_torch.obs.Observability`: the loop binds it
              onto the registry (engines + caches mirror into its metrics
              and trace onto its tracer), opens/closes per-ticket lifecycle
              spans, and — when the bundle is ACTIVE (tracing on) — records
              per-lane residual-vs-round convergence curves from each
              round's piggybacked poll (the same one blocking poll harvest
              pays for; recording adds zero fetches).  Default: a private
              disabled bundle, so instrumented code never branches.
    """

    def __init__(self, registry: EngineRegistry, queue: RequestQueue,
                 batcher: Optional[Batcher] = None, *, depth: int = 2,
                 chunk_iters: int = 0, refiner=None, cache: bool = False,
                 obs: Optional[Observability] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if chunk_iters < 0:
            raise ValueError(
                f"chunk_iters must be >= 0, got {chunk_iters}")
        if refiner is not None and not chunk_iters:
            raise ValueError(
                "refiner requires chunk_iters > 0: refinement splices "
                "continuations into live LaneBank lanes (stepwise mode)")
        self.registry = registry
        self.queue = queue
        self.batcher = batcher or Batcher()
        self.depth = depth
        self.chunk_iters = chunk_iters
        self.refiner = refiner
        self.cache = cache
        self.obs = obs if obs is not None else Observability.off()
        # one bundle spans the stack: engines + caches mirror into the
        # loop's registry whether or not tracing is on (duck-typed stub
        # registries without bind_obs simply skip the mirror)
        bind = getattr(registry, "bind_obs", None)
        if bind is not None:
            bind(self.obs)
        self.stats = StatsView(
            self.obs.metrics, "loop",
            initial={"dispatches": 0, "completed": 0, "failed": 0})
        if chunk_iters:
            self.stats.update(chunks=0, refills=0)
        if refiner is not None:
            self.stats.update(drafts=0, refines=0, preemptions=0)
        self.error: Optional[BaseException] = None
        self.control = RankControl()
        self._stopped = False           # a follower saw the leader's stop
        self._inflight: Deque[Tuple[Dispatch, object]] = collections.deque()
        self._banks: Dict = {}          # EngineKey -> LaneBank
        self._lane_tickets: Dict = {}   # EngineKey -> List[Optional[Ticket]]
        self._rounds: Dict = {}         # EngineKey -> stepwise round index
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- ticket lifecycle funnels (spans + stats + convergence) ---------------

    def _ticket_begin(self, ticket) -> None:
        """Open the ticket's lifecycle span if the queue didn't (a queue
        constructed without the shared bundle): idempotent, backdated to
        the request's arrival so queue wait still shows in the trace."""
        self.obs.tracer.async_begin(
            "ticket", ticket.seqno, key=ticket.key.describe(),
            ts_s=ticket.request.arrival_time)

    def _note_admit(self, ticket, now: Optional[float] = None) -> None:
        self._ticket_begin(ticket)
        self.obs.tracer.async_instant("admit", ticket.seqno)
        arrival = ticket.request.arrival_time
        if arrival is not None:
            if now is None:
                now = self.queue.clock()
            self.obs.metrics.histogram("loop.queue_wait_s").observe(
                max(now - arrival, 0.0), key=ticket.key.describe())

    def _resolve_ticket(self, ticket, result) -> None:
        """EVERY completion funnels here: close the convergence curve
        (attaching ``ticket.residual_curve``), close the lifecycle span,
        resolve the future, count it — exactly once per ticket."""
        curve = self.obs.convergence.finish(ticket)
        self._ticket_begin(ticket)
        # getattr, not attribute access: loop tests resolve tickets with
        # arbitrary stand-in results, and span args are best-effort
        self.obs.tracer.async_end(
            "ticket", ticket.seqno, key=ticket.key.describe(),
            iters=getattr(result, "iters", None),
            nfe=getattr(result, "nfe", None),
            converged=getattr(result, "converged", None),
            early_stopped=getattr(result, "early_stopped", None),
            residual_curve=curve)
        ticket.resolve(result)
        self.stats["completed"] += 1

    def _fail_ticket(self, ticket, error: BaseException) -> None:
        """EVERY failure funnels here — span closed with the error, partial
        convergence curve discarded, counted exactly once."""
        self.obs.convergence.discard(ticket)
        self._ticket_begin(ticket)
        self.obs.tracer.async_end("ticket", ticket.seqno,
                                  key=ticket.key.describe(),
                                  error=str(error))
        ticket.fail(error)
        self.stats["failed"] += 1

    # -- one scheduling round ------------------------------------------------

    def pump(self, *, flush: bool = False) -> int:
        """One scheduling round; returns the number of requests newly
        dispatched/admitted.  Whole-batch mode plans fixed-slot dispatches
        and collects the oldest in-flight batch whenever the pipeline is at
        ``depth``; stepwise mode harvests/refills/advances the live banks.
        """
        self._assert_not_threaded()
        leader = self.control.leader
        header = self.control.share(
            self._round_header(flush) if leader else None)
        if header["stop"]:
            self._stopped = True
            return 0
        self._on_header(header)
        if not self._serving():
            return 0
        flush = header["flush"]
        if leader:
            self._sweep_timeouts()
        if self.chunk_iters:
            return self._pump_stepwise(flush=flush)
        if not leader:
            return self._follow_dispatches()
        plans = self.batcher.plan(
            self.queue, self.registry, now=self.queue.clock(),
            flush=flush, idle=not self._inflight)
        self.control.share([(p.key, [t.request for t in p.tickets], p.slots)
                            for p in plans], self._control_group())
        dispatched = 0
        for plan in plans:
            while len(self._inflight) >= self.depth:
                # free a slot: prefer a batch that already finished, fall
                # back to blocking on the oldest
                ready = self._first_ready_index()
                self._collect_at(ready if ready is not None else 0)
            self._dispatch(plan)
            dispatched += len(plan.tickets)
        return dispatched

    # -- rank control (hooks the resilient loop extends) ----------------------

    def _round_header(self, flush: bool) -> Dict:
        """The leader's word on a round, sent to every rank first."""
        return {"stop": False, "flush": flush}

    def _on_header(self, header: Dict) -> None:
        """Act on the round header before the round (every rank)."""

    def _serving(self) -> bool:
        """Whether this rank takes part in rounds (a rank outside every
        engine's mesh only follows headers)."""
        return True

    def _control_group(self):
        """Process group of the ranks serving rounds (None = all)."""
        return None

    def _send_stop(self) -> None:
        """The leader ends the followers' drain (no-op at world size 1)."""
        if self.control.leader and self.control.world > 1:
            self.control.share({"stop": True, "flush": True})

    def _follow_dispatches(self) -> int:
        """A follower's whole-batch round: run the leader's dispatches and
        collect each at once (collecting issues no collective, so its
        order does not have to match the leader's)."""
        plans = self.control.share(None, self._control_group())
        for key, requests, slots in plans:
            try:
                engine = self.registry.get(key)
                engine.collect(engine.dispatch(requests, slots=slots))
            except Exception:  # noqa: BLE001 — the leader fails the tickets
                continue
        return sum(len(requests) for _, requests, _ in plans)

    def _sweep_timeouts(self) -> None:
        """Expire queued tickets whose ``SampleRequest.timeout_s`` elapsed
        before admission: each fails through the standard funnel (span
        closed, counted) with a ``TimeoutError``.  Runs at the top of every
        pump round, so an expired refine continuation is cancelled here too
        — its already-resolved draft stays deliverable."""
        sweep = getattr(self.queue, "sweep_expired", None)
        if sweep is None:
            return
        for ticket in sweep():
            waited = None
            if ticket.request.arrival_time is not None:
                waited = self.queue.clock() - ticket.request.arrival_time
            self._fail_ticket(ticket, TimeoutError(
                f"request {ticket.key.describe()}#{ticket.seqno} expired "
                f"in queue after {waited if waited is not None else '?'}s "
                f"(timeout_s={ticket.request.timeout_s})"))

    def drain(self) -> None:
        """Dispatch everything queued and collect every in-flight batch."""
        self._assert_not_threaded()
        if not self.control.leader:
            self._stopped = False
            while not self._stopped:
                self.pump()
            return
        if self.chunk_iters:
            while len(self.queue) or self._occupied_lanes():
                self.pump(flush=True)
        else:
            while len(self.queue):
                self.pump(flush=True)
            while self._inflight:
                self._collect_oldest()
        self._send_stop()

    @property
    def inflight(self) -> int:
        return len(self._inflight) if not self.chunk_iters \
            else self._occupied_lanes()

    # -- stepwise (iteration-level) rounds -----------------------------------

    def _occupied_lanes(self) -> int:
        return sum(bank.occupied for bank in self._banks.values())

    def _pump_stepwise(self, *, flush: bool = False) -> int:
        """harvest -> refill -> advance, every live/pending key per round.

        One-round-lag polling: ``stepwise_step`` at the END of a round both
        queues the chunk on the device without waiting and queues the
        device->host copy of its packed (slots, 5) scheduling summary
        behind it, so the blocking poll inside the NEXT round's harvest
        waits for that chunk's end and nothing else — host scheduling
        (refill packing, queue work, OTHER keys' rounds) overlaps device
        compute as far as the launch queue lets the host run ahead,
        and each round issues exactly ONE blocking fetch per live key
        (harvest and report share the round's cached poll).  Harvest then
        retires finished lanes with a device-side gather of just those
        lanes' rows; refill admission is :meth:`Batcher.plan_refill` —
        free lanes of an ACTIVE bank admit immediately (work-conserving:
        the chunk runs anyway), an idle bank applies the usual
        fill-or-deadline gate."""
        now = self.queue.clock()
        admitted = 0

        def starvation(key):
            oldest = self.queue.oldest_arrival(key)
            return (now if oldest is None else oldest, key)

        leader, group = self.control.leader, self._control_group()
        plan = None
        if leader:
            keys = sorted(set(self.queue.keys()) | set(self._banks),
                          key=starvation)
            plan = (keys, [k for k in keys if k not in self._banks
                           and self.queue.pending(k)])
        keys, opens = self.control.share(plan, group)
        for key in keys:
            try:
                engine = self.registry.get(key)
            except Exception as error:  # noqa: BLE001 — poisoned key
                for ticket in self.queue.pop(key, self.queue.pending(key)):
                    self._fail_ticket(ticket, error)
                continue
            bank = self._banks.get(key)
            if bank is None:
                if key not in opens:
                    continue
                try:
                    slots = self.batcher.slots_for(engine)
                    bank = engine.stepwise_open(
                        slots, chunk_iters=self.chunk_iters)
                except Exception as error:  # noqa: BLE001 — open
                    # failure poisons THIS key only: fail its pending
                    # tickets (nothing is admitted yet), keep serving
                    for ticket in self.queue.pop(key,
                                                 self.queue.pending(key)):
                        self._fail_ticket(ticket, error)
                    continue
                self._banks[key] = bank
                self._lane_tickets[key] = [None] * bank.slots
            tickets = self._lane_tickets[key]
            try:
                if self.obs.active and bank.occupied:
                    # convergence telemetry rides the round's ONE poll:
                    # harvest shares this cached fetch, so recording the
                    # per-lane residuals costs zero extra host traffic.
                    # Lanes are read at the START of the round — before
                    # harvest vacates retirees — so a lane's final
                    # residual lands on its curve.
                    polled = engine.stepwise_poll(bank)
                    rnd = self._rounds.get(key, 0)
                    self._rounds[key] = rnd + 1
                    self.obs.convergence.observe_round(
                        key, rnd, list(enumerate(tickets)), polled)
                for lane, result in engine.stepwise_harvest(bank):
                    ticket = tickets[lane]
                    tickets[lane] = None
                    if ticket is None:
                        continue
                    if self.refiner is not None and self.refiner.plan(
                            self.queue, ticket, result):
                        # taken as a DRAFT: stage one resolved, a warm-
                        # started continuation re-enqueued on this ticket
                        self.obs.tracer.async_instant(
                            "draft", ticket.seqno, lane=lane,
                            iters=result.iters)
                        self.stats["drafts"] += 1
                        self.stats["refines"] += 1
                        continue
                    self._resolve_ticket(ticket, result)
                    if self.cache and result.converged \
                            and not result.early_stopped:
                        self.registry.cache(key).record(result)
                if leader:
                    valid, share = self._plan_refill(key, engine, bank,
                                                     tickets, now, flush)
                    self.control.share(share, group)
                else:
                    preempt, lanes, requests = self.control.share(None,
                                                                  group)
                    for lane in preempt:
                        bank.requests[lane] = None
                    valid = [None] * len(requests)
                    share = (preempt, lanes, requests)
                admitted += self._refill(engine, bank, tickets, share[1],
                                         valid, share[2])
                if bank.occupied:
                    engine.stepwise_step(bank)
                    self.stats["chunks"] += 1
            except Exception as error:  # noqa: BLE001 — fail this bank's
                # tickets, drop the bank, keep serving other keys
                self._fail_bank(key, error)
        return admitted

    def _plan_refill(self, key, engine, bank, tickets, now, flush):
        """The leader's refill decision for one key's bank: the tickets to
        admit (validated) and the (preempted lanes, lanes, requests) every
        rank applies."""
        free = bank.free_lanes()
        # preemptible (refine) lanes are BACKGROUND occupancy: when fresh
        # non-preemptible arrivals outnumber the free lanes, count enough
        # refine lanes as admission slots and vacate them below —
        # background refinement never starves fresh-arrival admission
        # (their warm start rides the re-enqueued ticket, so preempted
        # progress degrades to the draft init, never to a cold start)
        background = [i for i, r in enumerate(bank.requests)
                      if r is not None and r.preemptible] \
            if self.refiner is not None else []
        extra = min(len(background),
                    max(self.queue.pending_urgent(key) - len(free), 0))
        admit = self.batcher.plan_refill(
            self.queue, key, len(free) + extra, now=now,
            active=bank.occupied > 0, flush=flush)
        preempt = background[:max(len(admit) - len(free), 0)]
        for lane in preempt:
            self._preempt(key, bank, tickets, lane)
        # a request the engine rejects (e.g. per-request tau on a seq key)
        # fails ITS OWN ticket here
        valid = []
        for ticket in admit:
            try:
                engine.validate_request(ticket.request)
            except Exception as error:  # noqa: BLE001
                self._fail_ticket(ticket, error)
            else:
                valid.append(ticket)
        lanes = bank.free_lanes()[:len(valid)]
        return valid, (preempt, lanes, [t.request for t in valid])

    def _refill(self, engine, bank, tickets, lanes, valid, requests) -> int:
        """Splice ``requests`` into ``lanes`` (``valid`` their tickets; None
        on a follower).  A refill that fails fails the admitted group — the
        popped tickets are accounted for, never leaked, and the bank keeps
        serving."""
        if not requests:
            return 0
        now = self.queue.clock()
        for ticket in valid:
            if ticket is not None:
                self._note_admit(ticket, now)
        try:
            engine.stepwise_refill(bank, lanes, requests)
        except Exception as error:  # noqa: BLE001
            for ticket in valid:
                if ticket is not None:
                    self._fail_ticket(ticket, error)
            return 0
        for lane, ticket in zip(lanes, valid):
            tickets[lane] = ticket
            if ticket is not None:
                self.obs.tracer.async_instant("splice", ticket.seqno,
                                              lane=lane)
        self.stats["refills"] += 1
        self.stats["dispatches"] += 1
        return len(requests)

    def _preempt(self, key, bank, tickets, lane) -> None:
        """Vacate one preemptible (refine) lane for an urgent admission:
        its ticket re-enters the queue with its warm-started request
        intact (the lane's in-flight device iterations since the splice
        are forfeited — the continuation restarts from its draft init),
        and the lane is overwritten by the same round's refill merge."""
        ticket = tickets[lane]
        tickets[lane] = None
        bank.requests[lane] = None
        self.stats["preemptions"] += 1
        if ticket is not None:
            self.obs.tracer.async_instant("preempt", ticket.seqno,
                                          lane=lane)
            self.queue.resubmit(ticket)

    def _fail_bank(self, key, error: BaseException) -> None:
        for ticket in self._lane_tickets.get(key, []):
            if ticket is not None:
                self._fail_ticket(ticket, error)
        self._banks.pop(key, None)
        self._lane_tickets.pop(key, None)

    def bank_reports(self) -> Dict:
        """Per-key stepwise work accounting (see ``stepwise_report``).

        Single-consumer like ``pump``/``drain``: ``stepwise_report`` shares
        the round's cached poll on the live bank, so reporting from a
        foreign thread while the background pump owns the banks would race
        the cache's step/refill invalidation — report after ``stop()`` (or
        between synchronous pumps) instead."""
        self._assert_not_threaded()
        return {key: self.registry.get(key).stepwise_report(bank)
                for key, bank in self._banks.items()}

    def _assert_not_threaded(self) -> None:
        """The pipeline state (``_inflight``) is single-consumer: while the
        background thread owns it, foreign threads must submit and wait on
        tickets, not pump."""
        if self._thread is not None \
                and threading.current_thread() is not self._thread:
            raise RuntimeError(
                "serving loop is running in a background thread; submit "
                "requests and wait on their tickets instead of pumping")

    def _dispatch(self, plan: Dispatch) -> None:
        engine = self.registry.get(plan.key)
        now = self.queue.clock()
        for ticket in plan.tickets:
            self._note_admit(ticket, now)
        try:
            pending = engine.dispatch(
                [t.request for t in plan.tickets], slots=plan.slots)
        except Exception as error:  # noqa: BLE001 — fail the batch, not the loop
            for ticket in plan.tickets:
                self._fail_ticket(ticket, error)
            return
        self._inflight.append((plan, pending))
        self.stats["dispatches"] += 1

    def _first_ready_index(self) -> Optional[int]:
        """Index of the first in-flight batch whose outputs are already
        computed (collecting it will not block), or None.  The background
        thread uses this to avoid head-of-line blocking: batches are
        independent, so a short batch that finished behind a long one can
        be collected — and its tickets resolved — out of order, while the
        free pipeline depth keeps absorbing new arrivals."""
        for index, (_, pending) in enumerate(self._inflight):
            if pending.ready():
                return index
        return None

    def _collect_oldest(self) -> None:
        self._collect_at(0)

    def _collect_at(self, index: int) -> None:
        plan, pending = self._inflight[index]
        del self._inflight[index]
        engine = self.registry.get(plan.key)
        try:
            results = engine.collect(pending)
        except Exception as error:  # noqa: BLE001
            for ticket in plan.tickets:
                self._fail_ticket(ticket, error)
            return
        if engine.last_dispatches:
            self.batcher.note(plan.key, engine.last_dispatches[-1])
        for ticket, result in zip(plan.tickets, results):
            self._resolve_ticket(ticket, result)
            if self.cache and result.converged and not result.early_stopped:
                self.registry.cache(plan.key).record(result)

    def _abort(self, error: BaseException) -> None:
        """Fail every in-flight, queued, and FUTURE ticket with ``error``
        (the loop died; clients must not block until their timeouts)."""
        self.error = error
        self.queue.close(error)
        while self._inflight:
            plan, _ = self._inflight.popleft()
            for ticket in plan.tickets:
                self._fail_ticket(ticket, error)
        for key in list(self._banks):
            self._fail_bank(key, error)
        for key in self.queue.keys():
            for ticket in self.queue.pop(key, self.queue.pending(key)):
                self._fail_ticket(ticket, error)

    # -- background-thread mode ----------------------------------------------

    def start(self, poll_s: float = 0.002) -> "ServingLoop":
        """Run the pump on a daemon thread until :meth:`stop`."""
        if self._thread is not None:
            raise RuntimeError("serving loop already started")
        self._stop_event.clear()
        self._stopped = False

        def follow():
            # a follower pumps the leader's rounds until its stop header
            try:
                while not self._stopped:
                    self.pump()
            except BaseException as error:  # noqa: BLE001
                self._abort(error)

        def run():
            try:
                while not self._stop_event.is_set():
                    if self.pump() == 0:
                        if self.chunk_iters:
                            # a round with live lanes already advanced them
                            # (and the next harvest blocks on that chunk);
                            # only a fully idle loop needs to sleep
                            if not self._occupied_lanes():
                                self._stop_event.wait(poll_s)
                            continue
                        # never park in a blocking collect here: collect
                        # any batch that already finished on device (out of
                        # order — batches are independent), otherwise poll
                        # so new arrivals keep dispatching into free depth
                        # and a short batch resolves the moment it is ready
                        ready = self._first_ready_index()
                        if ready is not None:
                            self._collect_at(ready)
                        else:
                            self._stop_event.wait(poll_s)
            except BaseException as error:  # noqa: BLE001 — a dead loop
                # must not strand clients in ticket.result(): fail
                # everything in flight and queued, record the error
                self._abort(error)

        self._thread = threading.Thread(
            target=run if self.control.leader else follow,
            name="serving-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop the background thread; by default drain what remains (on the
        caller's thread, after the worker has exited).

        EVERY open ticket resolves or fails by the time this returns:
        ``drain=True`` runs the remaining rounds (a drain failure aborts
        the loop — nothing is left hanging — then re-raises);
        ``drain=False`` fails whatever is still open (queued tickets,
        live lanes, in-flight batches — including two-tier tickets whose
        draft resolved but whose refine continuation is still pending)
        with :class:`ShutdownError` instead of stranding their
        ``result()`` callers."""
        if self._thread is None:
            return
        if not self.control.leader:
            self._thread.join()     # ends at the leader's stop header
            self._thread = None
            return
        self._stop_event.set()
        self._thread.join()
        self._thread = None
        if self.error is not None:
            self._send_stop()
            return                  # worker aborted: everything failed already
        if drain:
            try:
                self.drain()
            except BaseException:
                if self.error is None:
                    # drain aborts the loop on a worker-style failure path
                    # only when pump() raised outside a per-bank handler;
                    # make sure nothing stays open either way
                    self._abort(ShutdownError(
                        "serving loop drain failed during stop()"))
                raise
            return
        if self._inflight or self._occupied_lanes() or len(self.queue) \
                or any(t is not None
                       for lanes in self._lane_tickets.values()
                       for t in lanes):
            self._abort(ShutdownError(
                "serving loop stopped (drain=False) before completing "
                "open tickets"))
        self._send_stop()

    def __enter__(self) -> "ServingLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
