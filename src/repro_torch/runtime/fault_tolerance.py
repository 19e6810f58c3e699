"""Fault-tolerance runtime: heartbeats, restart supervision, stragglers.

A copy of the JAX package's ``repro.runtime.fault_tolerance`` with the same
names and behaviour.  At 1000+ nodes the control plane is as important as
the math.  This module is pure Python (no torch state) so it is
unit-testable with simulated failures; the launcher
(repro_torch.launch.train) wires it around the train step:

  * HeartbeatMonitor — workers report (worker, step, t); the monitor flags
    workers silent for > timeout as failed and computes the surviving set.
  * RestartPolicy — exponential-backoff restart budget; decides between
    in-place restart (same mesh) and elastic downsize (see elastic.py).
  * StragglerMitigator — per-step deadline tracking from a rolling latency
    percentile.  For ParaTAA serving, the mitigation is window
    over-provisioning: the slowest timestep-shard is duplicated on spare
    capacity and the first finisher wins (both compute identical values, so
    the race is deterministic in value).  For training it surfaces
    skip-or-wait decisions to the loop.
  * run_supervised — the checkpoint-restore-retry driver used by train.py;
    simulated-crash tests in tests/test_torch_runtime.py exercise it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, List, Optional, Set


class HeartbeatMonitor:
    def __init__(self, workers: Iterable[int], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last_seen: Dict[int, float] = {w: clock() for w in workers}
        self.last_step: Dict[int, int] = {w: -1 for w in workers}

    def beat(self, worker: int, step: int):
        self.last_seen[worker] = self.clock()
        self.last_step[worker] = step

    def failed(self) -> Set[int]:
        now = self.clock()
        return {w for w, t in self.last_seen.items() if now - t > self.timeout}

    def alive(self) -> Set[int]:
        return set(self.last_seen) - self.failed()

    def quorum(self, fraction: float = 0.75) -> bool:
        return len(self.alive()) >= fraction * len(self.last_seen)


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 300.0
    elastic_after: int = 2  # failed in-place restarts before downsizing

    restarts: int = 0

    def next_action(self) -> str:
        """'restart' | 'elastic' | 'abort'."""
        if self.restarts >= self.max_restarts:
            return "abort"
        return "elastic" if self.restarts >= self.elastic_after else "restart"

    def backoff(self) -> float:
        return min(self.backoff_cap_s, self.backoff_base_s * 2 ** self.restarts)

    def record_restart(self):
        self.restarts += 1

    def record_success_window(self):
        self.restarts = 0


class StragglerMitigator:
    """Rolling p50/p95 step-latency tracker with deadline + duplication
    decisions."""

    def __init__(self, window: int = 50, deadline_factor: float = 3.0):
        self.lat = deque(maxlen=window)
        self.deadline_factor = deadline_factor

    def record(self, seconds: float):
        self.lat.append(seconds)

    def _pct(self, p: float) -> Optional[float]:
        if not self.lat:
            return None
        s = sorted(self.lat)
        return s[min(len(s) - 1, int(p * len(s)))]

    def deadline(self) -> Optional[float]:
        p50 = self._pct(0.5)
        return None if p50 is None else self.deadline_factor * p50

    def is_straggling(self, seconds: float) -> bool:
        d = self.deadline()
        return d is not None and seconds > d

    def duplicate_assignments(self, shard_latencies: Dict[int, float],
                              spare_slots: int) -> List[int]:
        """Pick the slowest shards (up to spare capacity) for duplicate
        dispatch — used by the serving launcher for ParaTAA window shards."""
        ranked = sorted(shard_latencies, key=shard_latencies.get, reverse=True)
        d = self.deadline()
        out = []
        for s in ranked[:spare_slots]:
            if d is None or shard_latencies[s] > d:
                out.append(s)
        return out


def run_supervised(step_fn: Callable[[int], None], *, start_step: int,
                   num_steps: int, save_fn: Callable[[int], None],
                   restore_fn: Callable[[], int], policy: RestartPolicy,
                   ckpt_every: int = 100,
                   on_failure: Optional[Callable[[BaseException, int], None]] = None):
    """Run step_fn for steps [start_step, num_steps), checkpointing every
    ckpt_every and restoring+retrying on failure per `policy`.  Returns the
    final step reached."""
    step = start_step
    while step < num_steps:
        try:
            step_fn(step)
            step += 1
            if step % ckpt_every == 0:
                save_fn(step)
                policy.record_success_window()
        except Exception as e:  # noqa: BLE001 — any step failure
            if on_failure is not None:
                on_failure(e, step)
            action = policy.next_action()
            if action == "abort":
                raise
            policy.record_restart()
            step = restore_fn()  # roll back to last durable checkpoint
    return step
