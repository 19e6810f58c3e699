"""repro_torch.obs — unified observability for the serving stack.

Three pillars, one facade:

  * :mod:`repro_torch.obs.metrics` — a typed, thread-safe
    :class:`MetricsRegistry` (Counter/Gauge/Histogram with label sets,
    ``snapshot()``/``delta()``) every serving layer registers into; the
    legacy ``stats`` dicts stay available verbatim as
    :class:`StatsView`\\ s mirroring into it.
  * :mod:`repro_torch.obs.trace` — :class:`SpanTracer`: monotonic-clock span
    tracing (engine pack/dispatch/collect and stepwise
    open/refill/step/poll/harvest spans; per-ticket
    submit -> validate -> admit -> splice -> draft -> refine-resubmit ->
    resolve lifecycle spans) with Chrome-trace-event JSON export
    (``serve.py --trace-out trace.json`` loads in Perfetto).
  * :mod:`repro_torch.obs.convergence` — :class:`ConvergenceRecorder`:
    per-lane, per-round fixed-point residual curves, fed by the residual
    column the stepwise step packs into its (slots, 5) poll summary (zero
    extra fetches).

:class:`Observability` bundles the three.  The cardinal rule:
instrumentation is PROTOCOL-NEUTRAL — an enabled Observability changes no
program count (still exactly 5 stepwise program kinds), no blocking-poll
or host-fetch accounting, and no solve bit.  ``Observability.off()`` (what every
component defaults to) keeps a working private metrics registry and a
no-op tracer, so instrumented code never branches on "is obs on".
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.obs.convergence import ConvergenceRecorder
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               StatsView)
from repro_torch.obs.trace import SpanTracer, json_safe

__all__ = [
    "Observability",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "StatsView",
    "SpanTracer", "json_safe",
    "ConvergenceRecorder",
]


class Observability:
    """One bundle of (metrics registry, span tracer, convergence recorder)
    shared across a serving stack.

    Wire the SAME instance into the :class:`~repro_torch.serving.RequestQueue`,
    :class:`~repro_torch.serving.ServingLoop` (which forwards it to the
    :class:`~repro_torch.serving.EngineRegistry` and through it to every
    engine and trajectory cache), and the :class:`~repro_torch.serving.Batcher`
    — then ``metrics.snapshot()`` spans the whole stack and
    ``tracer.export(path)`` writes one coherent trace.
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 convergence: Optional[ConvergenceRecorder] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else SpanTracer(enabled=False)
        self.convergence = convergence if convergence is not None \
            else ConvergenceRecorder(self.metrics)

    @property
    def active(self) -> bool:
        """True when lifecycle tracing + convergence curves are recorded
        (metrics mirror regardless — they are cheap and always useful)."""
        return self.tracer.enabled

    @classmethod
    def enabled(cls, clock: Callable[[], float] = time.monotonic,
                max_events: int = 1_000_000) -> "Observability":
        """A fully-on bundle (span tracing + convergence curves)."""
        return cls(tracer=SpanTracer(enabled=True, clock=clock,
                                     max_events=max_events))

    @classmethod
    def off(cls) -> "Observability":
        """A private, tracing-disabled bundle — the default every
        component constructs for itself when none is wired in, so
        un-instrumented usage needs no conditionals and pays no tracing
        cost (each instance gets its OWN registry; label collisions
        between unrelated components cannot happen)."""
        return cls()
