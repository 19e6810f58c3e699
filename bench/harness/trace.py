"""The device trace of a window, reduced: busy seconds, device time by
operation, and the idle gaps by what the host was doing.

``torch.profiler`` records a part of the window; the raw events are read
from its results without building the profiler's own event tree.  Busy
time is the union of the intervals of every device event (kernels,
copies, sets).  An idle gap is a hole in that union; it is charged to the
innermost host event running at the gap's start.  A run traces twice: the
device's activity alone, which the metrics read, then the host's
operations too, which slow the host several-fold and serve only to name
the idle gaps in the breakdown.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

#: entries of each breakdown list
TOP = 10


def _is_device(event) -> bool:
    return str(event.device_type()).split(".")[-1] == "CUDA"


def reduce_events(device: List[tuple], host: List[tuple],
                  window_ns: Tuple[int, int]) -> dict:
    """``device``/``host``: (name, start_ns, end_ns).  ``window_ns``: the
    window's bounds on the events' clock.  Returns busy_s, by_op
    {name: [seconds, count]}, idle_gaps [(name, seconds)] summed by name."""
    lo, hi = window_ns
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in device
                   if e > lo and s < hi)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > lo:
                gaps.append((lo, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < hi:
            gaps.append((cur_e, hi))
    by_op: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in device:
        rec = by_op[name]
        rec[0] += (e - s) / 1e9
        rec[1] += 1
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        idle[_host_at(host, starts, g0)] += (g1 - g0) / 1e9
    return {"busy_s": busy / 1e9, "by_op": dict(by_op),
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])}


def _host_at(host, starts, t: int, reach: int = 4096) -> str:
    """The innermost host event running at ``t`` (the latest-starting one
    that covers it), or "host: none"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        name, s, e = host[j]
        if s <= t <= e:
            return name
    return "host: none"


def top(pairs, n: int = TOP):
    return [[name, seconds] for name, seconds in pairs[:n]]


def short(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


class Profile:
    """``torch.profiler`` from ``start()`` to ``stop()`` (which waits for
    the device first); ``summary()`` after it stopped.  ``host``: record
    the host's operations besides the device's activity."""

    def __init__(self, host: bool):
        import torch

        self._torch = torch
        activities = [torch.profiler.ProfilerActivity.CUDA]
        if host:
            activities.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=activities)
        self.running = self.stopped = False

    def start(self) -> None:
        if not self.running and not self.stopped:
            self._prof.start()
            self.running = True

    def stop(self) -> None:
        if self.running:
            self._torch.cuda.synchronize()
            self._prof.stop()
            self.running, self.stopped = False, True

    @classmethod
    def warm(cls) -> None:
        """Starts and stops the profiler of each kind once over a small
        device op, so that its one-time start-up falls in set-up, not in
        the window."""
        import torch

        for host in (False, True):
            prof = cls(host=host)
            prof.start()
            torch.ones(1, device="cuda").add_(1)
            prof.stop()

    def summary(self) -> dict:
        if not self.stopped:
            return None
        events = self._prof.profiler.kineto_results.events()
        device, host = [], []
        for ev in events:
            s = ev.start_ns()
            (device if _is_device(ev) else host).append(
                (ev.name(), s, s + ev.duration_ns()))
        if device or host:
            lo = min(s for _, s, _ in device + host)
            hi = max(e for _, _, e in device + host)
        else:
            lo = hi = 0
        out = reduce_events(device, host, (lo, hi))
        out["window_s"] = (hi - lo) / 1e9
        out["device_events"] = len(device)
        out["host_events"] = len(host)
        return out
