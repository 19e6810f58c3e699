"""The window opens after the mix's lead-in, the arrival process says when
each request goes out, and marks fall at their offsets from the window's
opening: ``Stack.run`` over a stand-in serving loop on a simulated clock
(each request served in a fixed time, rounds of a fixed length)."""
import pytest

from bench.harness.catalog import Catalog
from bench.harness.serve import Stack
from bench.tests.support import ROOT

ROUND_S = 0.1


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


class Ticket:
    def __init__(self, due):
        self.due, self.on_draft, self.result = due, None, None

    def done(self):
        return self.result is not None


class Queue:
    def __init__(self, clock, service_s):
        self.clock, self.service_s, self.tickets = clock, service_s, []

    def submit(self, request, key):
        ticket = Ticket(self.clock() + self.service_s)
        self.tickets.append(ticket)
        return ticket


class Loop:
    """One round: the clock moves on, then every due ticket resolves."""

    def __init__(self, clock, queue):
        self.clock, self.queue = clock, queue

    def pump(self):
        self.clock.now += ROUND_S
        for ticket in list(self.queue.tickets):
            if ticket.result is None and ticket.due <= self.clock.now:
                ticket.result = object()
                ticket.on_draft(ticket.result)


def stack(clock, service_s):
    s = Stack.__new__(Stack)
    s.key, s.queue = "key", Queue(clock, service_s)
    s.loop = Loop(clock, s.queue)
    return s


def closed(clients, stagger_s):
    arrivals = Catalog(ROOT).module("arrivals", "closed")
    return arrivals.Arrivals({"clients": clients, "stagger_s": stagger_s}, 1)


def test_window_opens_after_the_lead_in():
    clock = Clock()
    seen = []
    records, begin, start, end = stack(clock, 1.0).run(
        lambda rid: rid, closed(2, 0.5), 4.0, lead_in_s=3.0,
        marks=[(0.0, lambda: seen.append(clock())),
               (1.0, lambda: seen.append(clock())),
               (9.0, lambda: seen.append(clock()))], clock=clock)
    assert begin == 100.0 and start == 103.0 and end == 107.0
    # each mark between two rounds once due, the late one after the end
    assert start <= seen[0] < start + ROUND_S + 1e-9
    assert start + 1.0 <= seen[1] < start + 1.0 + ROUND_S + 1e-9
    assert seen[2] >= end
    # the clients start 0.5 s apart at the traffic's start and send again
    # the moment a result comes back, never after the window's end
    first = [r for r in records if r.rid < 2]
    assert [r.client for r in first] == [0, 1]
    for client in (0, 1):
        mine = [r for r in records if r.client == client]
        for prev, nxt in zip(mine, mine[1:]):
            assert nxt.ticket.due == pytest.approx(prev.done_at + 1.0)
        assert all(r.ticket.due - 1.0 < end for r in mine)
    assert any(r.done_at < start for r in records)      # in the lead-in
    assert any(start <= r.done_at <= end for r in records)


def test_a_mark_schedules_its_follow_up_from_its_return():
    clock, seen = Clock(), []

    def slow():
        clock.now += 2.0                # a mark that takes 2 s
        seen.append(clock())
        return 0.5, lambda: seen.append(clock())

    stack(clock, 1.0).run(lambda rid: rid, closed(1, 0.0), 5.0,
                          marks=[(1.0, slow)], clock=clock)
    # due 0.5 s after ``slow`` returned, not 0.5 s after it was due
    assert seen[0] + 0.5 <= seen[1] < seen[0] + 0.5 + ROUND_S + 1e-9


def test_a_scheduled_send_waits_for_its_time():
    class Spaced:
        """One client, its next request 0.35 s after each result."""

        def first(self, horizon_s):
            return [(0.0, 0)]

        def after(self, client, at_s):
            return at_s + 0.35, client

    clock = Clock()
    records, begin, _, end = stack(clock, 0.5).run(
        lambda rid: rid, Spaced(), 3.0, clock=clock)
    sent = [r.ticket.due - 0.5 for r in records]
    for r, nxt in zip(records, sent[1:]):
        assert r.done_at + 0.35 <= nxt < r.done_at + 0.35 + ROUND_S + 1e-9
    assert len(records) == 4 and sent[-1] < end
