"""The system under test, driven as a user drives it: requests go through
the program's ``RequestQueue`` to a ``ServingLoop`` over an
``EngineRegistry`` of ``SamplingEngine``s, in stepwise mode.

The loop is pumped from this thread (no serving thread).  The mix's
arrival process (``bench/arrivals/<name>.py``) says when each request is
sent; a send that a result brings and that is due at once goes out from
the ticket's ``on_draft`` callback, inside the round that harvested the
result, so the freed lane can take it in the same round's refill.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Callable, List, Optional

import torch


class TimedEps:
    """The engine's denoiser, with CUDA events around each call while
    ``timing`` is on (one call an iteration); it does no other work."""

    def __init__(self, eps_apply: Callable):
        self.eps_apply = eps_apply
        self.timing = False
        self.events: List[tuple] = []

    def __call__(self, params, x, taus, labels):
        if not self.timing:
            return self.eps_apply(params, x, taus, labels)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.eps_apply(params, x, taus, labels)
        end.record()
        self.events.append((start, end))
        return out

    def elapsed_ms(self) -> List[float]:
        """Each timed call's device milliseconds (after a synchronize)."""
        return [s.elapsed_time(e) for s, e in self.events]


@dataclasses.dataclass
class Record:
    """One request of the window."""
    rid: int
    client: int
    ticket: object
    done_at: Optional[float] = None
    result: object = None


class Stack:
    """One engine key served through the program's serving stack."""

    def __init__(self, eps: TimedEps, params, coeffs, spec, sample_shape,
                 mix: dict, device, noise_fn: Callable, *, obs=None):
        from repro_torch.sampling import SamplingEngine
        from repro_torch.serving import (Batcher, BatchingPolicy, EngineKey,
                                         EngineRegistry, RequestQueue,
                                         ServingLoop)

        def factory(key):
            return SamplingEngine(eps, params, coeffs, spec,
                                  sample_shape=sample_shape, device=device,
                                  noise_fn=noise_fn)

        self.key = EngineKey("bench", int(mix["T"]), mix["sampler"])
        self.registry = EngineRegistry(factory)
        self.queue = RequestQueue(obs=obs)
        policy = BatchingPolicy(max_batch=int(mix["slots"]),
                                max_wait_s=float(mix["max_wait_s"]))
        self.loop = ServingLoop(self.registry, self.queue,
                                Batcher(policy, metrics=obs and obs.metrics),
                                chunk_iters=int(mix["chunk_iters"]), obs=obs)
        self.mix = mix

    @property
    def engine(self):
        return self.registry.get(self.key)

    def warmup(self, request) -> None:
        """One whole solve at the serving geometry, counted as set-up."""
        self.registry.warmup(self.key,
                             slots=self.loop.batcher.slots_for(self.engine),
                             chunk_iters=int(self.mix["chunk_iters"]),
                             request=request)

    def run(self, make_request: Callable[[int], object], arrivals,
            seconds: float, *, lead_in_s: float = 0.0, marks=(),
            clock: Callable[[], float] = time.monotonic):
        """Sends requests as ``arrivals`` schedules them (seconds from the
        traffic's start); the measured window opens ``lead_in_s`` after
        that start and lasts ``seconds``.  A finished request is handed to
        ``arrivals.after``.  ``marks``: (seconds from the window's
        opening, callable) pairs, each called between two rounds once
        due, those past the window's end after it; a mark may return
        another such pair, its seconds counted from its return.  Returns
        (records of every request sent, the traffic's start, the window's
        start, its end); the loop is pumped until the first round that
        starts after the end."""
        records: List[Record] = []
        begin = clock()
        start = begin + float(lead_in_s)
        end = start + seconds
        order = itertools.count()
        sends = [(begin + at, next(order), client)
                 for at, client in arrivals.first(end - begin)]
        heapq.heapify(sends)
        due = [(start + float(at), next(order), fn) for at, fn in marks]
        heapq.heapify(due)

        def mark() -> None:
            nxt = heapq.heappop(due)[2]()
            if nxt is not None:
                heapq.heappush(due, (clock() + float(nxt[0]), next(order),
                                     nxt[1]))

        def send(client: int) -> None:
            rid = len(records)
            ticket = self.queue.submit(make_request(rid), self.key)
            record = Record(rid=rid, client=client, ticket=ticket)
            records.append(record)
            ticket.on_draft = lambda result, r=record: back(r, result)

        def back(record: Record, result) -> None:
            record.done_at = clock()
            record.result = result
            nxt = arrivals.after(record.client, record.done_at - begin)
            if nxt is None or begin + nxt[0] >= end:
                return
            if begin + nxt[0] <= record.done_at:
                send(nxt[1])
            else:
                heapq.heappush(sends, (begin + nxt[0], next(order), nxt[1]))

        while True:
            now = clock()
            while sends and sends[0][0] <= now:
                at, _, client = heapq.heappop(sends)
                if at < end:
                    send(client)
            while due and due[0][0] <= now:
                mark()
            if now >= end:
                break
            self.loop.pump()
        while due:                          # marks past the window's end
            mark()
        return records, begin, start, end

    def bank_report(self) -> Optional[dict]:
        """The live bank's ``stepwise_report`` (its work over its life)."""
        reports = self.loop.bank_reports()
        return reports.get(self.key)
