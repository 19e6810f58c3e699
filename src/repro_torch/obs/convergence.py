"""Per-lane, per-round fixed-point convergence telemetry.

ParaTAA's value is an iterations trade (paper eq. 6: T sequential denoiser
calls; Algorithm 1: far fewer fixed-point iterations) — the signal that
shows the trade working is the per-lane first-order residual shrinking
round over round.  The stepwise step program piggybacks exactly that
signal onto its packed scheduling summary (one f32 residual column riding
the SAME (slots, 5) array the host already polls once per round — zero
extra fetches, see ``SamplingEngine.stepwise_poll``); this module turns
those polled residuals into per-ticket residual-vs-round curves.

:class:`ConvergenceRecorder` is fed once per round by the
:class:`~repro_torch.serving.ServingLoop` (``observe_round`` with the round's
cached poll) and drained at ticket resolution (``finish`` attaches the
curve to ``Ticket.residual_curve`` and feeds the rounds-to-retire
histogram).  Curves key on ticket seqno, so a two-tier ticket's draft
rounds and refine-continuation rounds accumulate into ONE curve — the
full convergence history of the request across preemptions and resubmits.

Sequential ("seq") lanes never produce first-order residuals (eq. 6 has
no fixed point to converge to); their curve entries carry
``residual=None`` (the polled value is +inf) while still recording the
per-round iteration progress.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["ConvergenceRecorder"]


class ConvergenceRecorder:
    """Accumulates residual-vs-round curves per in-flight ticket."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics
        self._lock = threading.Lock()
        self._curves: Dict[int, List[Dict]] = {}   # ticket seqno -> points

    def observe_round(self, key, round_index: int,
                      lanes: Iterable[Tuple[int, object]],
                      polled: Dict) -> None:
        """Record one serving round from the round's (cached) poll.

        lanes:  ``(lane, ticket)`` pairs live at the START of the round —
                i.e. before this round's harvest vacates retirees, so a
                lane's final residual lands on its curve.
        polled: ``SamplingEngine.stepwise_poll`` output (``iters``/``nfe``
                plus the piggybacked ``residual`` column).
        """
        residuals = polled.get("residual")
        with self._lock:
            for lane, ticket in lanes:
                if ticket is None:
                    continue
                res = None
                if residuals is not None:
                    val = float(residuals[lane])
                    res = val if math.isfinite(val) else None
                self._curves.setdefault(ticket.seqno, []).append(dict(
                    round=round_index, lane=lane,
                    iters=int(polled["iters"][lane]),
                    residual=res))

    def curve(self, ticket) -> List[Dict]:
        with self._lock:
            return list(self._curves.get(ticket.seqno, ()))

    def finish(self, ticket) -> List[Dict]:
        """Pop the ticket's curve at resolution: attach it to the ticket
        (``Ticket.residual_curve``) and feed the convergence histograms."""
        with self._lock:
            curve = self._curves.pop(ticket.seqno, [])
        ticket.residual_curve = curve
        if self.metrics is not None and curve:
            self.metrics.histogram(
                "convergence.rounds_to_retire").observe(len(curve))
            last = curve[-1]["residual"]
            if last is not None:
                self.metrics.histogram(
                    "convergence.final_residual").observe(last)
        return curve

    def discard(self, ticket) -> None:
        """Drop a failed ticket's partial curve."""
        with self._lock:
            self._curves.pop(ticket.seqno, None)

    def open_curves(self) -> int:
        with self._lock:
            return len(self._curves)
