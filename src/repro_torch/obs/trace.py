"""Monotonic-clock span tracing with Chrome-trace-event JSON export.

One :class:`SpanTracer` is shared by every serving layer (via
:class:`~repro_torch.obs.Observability`).  Two event families cover the stack:

  * COMPLETE spans (``span(...)`` context manager, phase ``"X"``) for
    engine work units — pack/dispatch/collect on the whole-batch path,
    stepwise open/refill/step/poll/harvest/gather per round — each on a
    per-engine track (``tid``);
  * NESTABLE ASYNC spans (``async_begin``/``async_instant``/``async_end``,
    phases ``"b"``/``"n"``/``"e"``) for ticket lifecycles: one span per
    ticket seqno running submit -> resolve, with instant markers for
    validate/admit/splice/draft/refine-resubmit/preempt along the way and
    the final event carrying the ticket's per-round residual curve.

Timestamps come from ``time.monotonic()`` (never wall clock — NTP steps
would fold spans backward) relative to the tracer's construction, exported
in microseconds per the Chrome trace-event spec, so ``export(path)``
writes a file Perfetto / ``chrome://tracing`` loads directly
(``serve.py --trace-out trace.json``).

A disabled tracer (``SpanTracer(enabled=False)``, the default everywhere
an :class:`~repro_torch.obs.Observability` was not explicitly enabled) no-ops
every call: instrumented code never branches on whether tracing is on.
Event storage is bounded (``max_events``); overflow drops new events and
counts them (``dropped``) instead of growing without bound on long soaks.
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

__all__ = ["SpanTracer", "json_safe"]


def json_safe(value):
    """Recursively coerce ``value`` into strict-JSON-serializable data:
    numpy scalars/arrays -> python, non-finite floats -> None (strict JSON
    has no Infinity/NaN literals, and Perfetto rejects them)."""
    if isinstance(value, dict):
        return {str(k): json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_safe(v) for v in value]
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return value
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    item = getattr(value, "item", None)   # numpy scalars
    if callable(item):
        try:
            return json_safe(item())
        except (TypeError, ValueError):
            pass
    tolist = getattr(value, "tolist", None)  # numpy arrays
    if callable(tolist):
        return json_safe(tolist())
    return str(value)


class SpanTracer:
    """Thread-safe span recorder in Chrome trace-event form.

    enabled:    False makes every method a cheap no-op (the default wiring
                for un-instrumented runs).
    clock:      monotonic timestamp source (injectable for deterministic
                tests, mirroring the queue's pattern).
    max_events: bound on stored events; overflow counts into ``dropped``.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 max_events: int = 1_000_000):
        self.enabled = enabled
        self.clock = clock
        self.max_events = max_events
        self.dropped = 0
        self._t0 = clock()
        self._lock = threading.Lock()
        self._events: List[Dict] = []
        self._tids: Dict[str, int] = {}
        self._open_async: set = set()

    # -- clock ---------------------------------------------------------------

    def _ts_us(self, at_s: Optional[float] = None) -> float:
        t = self.clock() if at_s is None else at_s
        return max(t - self._t0, 0.0) * 1e6

    def _tid(self, label: str) -> int:
        tid = self._tids.get(label)
        if tid is None:
            tid = self._tids[label] = len(self._tids) + 1
        return tid

    def _emit(self, event: Dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    # -- complete spans ------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "span", tid: str = "main",
             **args):
        """Record one complete ("X") span around the with-block."""
        if not self.enabled:
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            ts = self._ts_us(t0)
            self._emit({"name": name, "cat": cat, "ph": "X", "ts": ts,
                        "dur": self._ts_us() - ts, "pid": 1,
                        "tid": self._tid(tid),
                        "args": json_safe(args) if args else {}})

    def instant(self, name: str, *, cat: str = "span", tid: str = "main",
                **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self._ts_us(), "pid": 1, "tid": self._tid(tid),
                    "args": json_safe(args) if args else {}})

    # -- nestable async spans (ticket lifecycles) ----------------------------

    def _async(self, ph: str, name: str, ident, cat: str,
               ts: Optional[float], args: Dict) -> None:
        self._emit({"name": name, "cat": cat, "ph": ph,
                    "id": str(ident), "ts": self._ts_us(ts), "pid": 1,
                    "tid": self._tid(cat),
                    "args": json_safe(args) if args else {}})

    def async_begin(self, name: str, ident, *, cat: str = "ticket",
                    ts_s: Optional[float] = None, **args) -> None:
        """Open the (cat, ident) async span — idempotent, so the queue's
        submit-time begin and the loop's admit-time fallback (for queues
        constructed without a tracer) never double-open a ticket span.
        ``ts_s`` backdates the begin to a recorded monotonic timestamp
        (e.g. the request's ``arrival_time``)."""
        if not self.enabled:
            return
        with self._lock:
            if (cat, ident) in self._open_async:
                return
            self._open_async.add((cat, ident))
        self._async("b", name, ident, cat, ts_s, args)

    def async_instant(self, name: str, ident, *, cat: str = "ticket",
                      **args) -> None:
        if not self.enabled:
            return
        self._async("n", name, ident, cat, None, args)

    def async_end(self, name: str, ident, *, cat: str = "ticket",
                  **args) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._open_async.discard((cat, ident))
        self._async("e", name, ident, cat, None, args)

    # -- export --------------------------------------------------------------

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def export(self, path) -> Path:
        """Write a Perfetto/chrome://tracing-loadable trace JSON file:
        ``{"traceEvents": [...]}`` with thread-name metadata for every
        track, strict JSON (``allow_nan=False`` — event args were
        sanitized at record time)."""
        with self._lock:
            events = list(self._events)
            tids = dict(self._tids)
        meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                 "args": {"name": label}} for label, tid in tids.items()]
        payload = {"traceEvents": meta + events,
                   "displayTimeUnit": "ms"}
        path = Path(path)
        path.write_text(json.dumps(payload, allow_nan=False))
        return path
