"""Warm-start trajectory cache (paper Sec 4.2).

ParaTAA's biggest lever on iteration count is a good initial trajectory: a
warm start from a previously solved trajectory of a SIMILAR condition cuts
the fixed-point iteration count several-fold.  The cache is that similarity
store, one per :class:`~repro_torch.serving.EngineKey` (trajectories are
(T+1, ...)-shaped per key, like the engines), hanging off the
:class:`~repro_torch.serving.EngineRegistry`.

Policy:

  * entries key on ``(label, seed)`` — the full identity of one solved
    request — so repeat traffic warm-starts from ITS OWN trajectory
    (the strongest init: same condition, same noise draw);
  * lookup degrades gracefully: exact ``(label, seed)`` -> most-recent
    same-label entry (a conditioning neighbor under a different noise
    draw) -> nearest label within a configurable ``neighborhood`` distance
    threshold (0, the default, allows no cross-label match);
  * eviction is LRU under BOTH an entry-count ``capacity`` and an optional
    ``max_bytes`` byte bound (trajectories are the dominant serving-layer
    host allocation: slots x (T+1) x sample_shape each);
  * ``hits`` / ``misses`` / ``evictions`` counters feed the serving stats
    summary (see ``ServingLoop.stats`` and ``serve.py --cache``).

Early-stopped results are never cached — a warm start should descend from a
fully-converged trajectory, not a draft another request may still refine.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

import numpy as np

from repro_torch.sampling.types import SampleResult, WarmStart


def _traj_nbytes(trajectory) -> int:
    nbytes = getattr(trajectory, "nbytes", None)
    if nbytes is None:
        nbytes = np.asarray(trajectory).nbytes
    return int(nbytes)


class TrajectoryCache:
    """Byte-bounded LRU of solved trajectories with neighborhood lookup.

    capacity:     max entries (>= 1).
    max_bytes:    optional total-bytes bound across entries; eviction keeps
                  evicting LRU entries until the new entry fits.  An entry
                  larger than ``max_bytes`` on its own is refused.
    neighborhood: label-distance threshold for cross-label matches — a
                  lookup that finds no same-label entry may fall back to
                  the nearest cached label with ``|label - cached| <=
                  neighborhood``.  0 (default) keeps exact-label semantics.
    metrics:      optional :class:`repro_torch.obs.MetricsRegistry` — hit/miss/
                  eviction events count into ``cache.*`` counters under the
                  ``key=name`` label (also attachable after construction
                  via :meth:`bind_metrics`; events before the bind live
                  only in the int counters, which stay authoritative).
    """

    def __init__(self, capacity: int = 64, *,
                 max_bytes: Optional[int] = None,
                 neighborhood: float = 0.0,
                 metrics=None, name: str = ""):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if neighborhood < 0:
            raise ValueError(
                f"neighborhood must be >= 0, got {neighborhood}")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.neighborhood = neighborhood
        self._metrics = metrics
        self._name = name
        self._lock = threading.Lock()
        # (label, seed) -> (trajectory, nbytes), LRU order
        self._store: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def bind_metrics(self, metrics, name: Optional[str] = None) -> None:
        """Start counting hit/miss/eviction events into ``metrics`` (the
        :class:`~repro_torch.serving.EngineRegistry` binds its shared
        observability bundle here)."""
        self._metrics = metrics
        if name is not None:
            self._name = name

    def _count(self, event: str, amount: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.counter(f"cache.{event}").inc(
                amount, key=self._name)

    # -- write side ----------------------------------------------------------

    def record(self, result: SampleResult) -> bool:
        """Offer one solved result; returns True if it was cached.

        Refused: unconverged or early-stopped results (drafts), results
        with no originating request (no identity to key on), and entries
        that cannot fit the byte bound even alone.
        """
        if not result.converged or result.early_stopped \
                or result.request is None:
            return False
        nbytes = _traj_nbytes(result.trajectory)
        if self.max_bytes is not None and nbytes > self.max_bytes:
            return False
        key = (result.request.label, result.request.seed)
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._store[key] = (result.trajectory, nbytes)
            self._bytes += nbytes
            evicted = 0
            while len(self._store) > self.capacity or (
                    self.max_bytes is not None
                    and self._bytes > self.max_bytes):
                _, (_, evicted_bytes) = self._store.popitem(last=False)
                self._bytes -= evicted_bytes
                self.evictions += 1
                evicted += 1
        self._count("records")
        if evicted:
            self._count("evictions", evicted)
        return True

    # -- read side -----------------------------------------------------------

    def lookup(self, label: int, t_init: Optional[int] = None, *,
               seed: Optional[int] = None) -> Optional[WarmStart]:
        """Best-available :class:`WarmStart` for a request's condition.

        Preference order: exact ``(label, seed)`` entry (when ``seed`` is
        given) -> most-recent same-label entry -> nearest label within
        ``neighborhood``.  A hit LRU-refreshes the entry; every call counts
        toward ``hits``/``misses``.
        """
        with self._lock:
            key = self._match(label, seed)
            if key is None:
                self.misses += 1
                hit = False
            else:
                self.hits += 1
                self._store.move_to_end(key)
                traj = self._store[key][0]
                hit = True
        self._count("hits" if hit else "misses")
        if not hit:
            return None
        return WarmStart(trajectory=traj, t_init=t_init)

    def _match(self, label, seed):
        """Lookup policy under the lock; returns a store key or None."""
        if seed is not None and (label, seed) in self._store:
            return (label, seed)
        best = None
        best_dist = None
        # most-recent wins among equal distances: scan in LRU order so a
        # later (more recent) candidate at the same distance replaces an
        # earlier one
        for key in self._store:
            try:
                dist = abs(label - key[0])
            except TypeError:            # non-numeric conditioning labels
                dist = 0 if label == key[0] else None
            if dist is None or (dist > 0 and dist > self.neighborhood):
                continue
            if best_dist is None or dist <= best_dist:
                best, best_dist = key, dist
        return best

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Counter snapshot for the serving stats summary."""
        with self._lock:
            return dict(hits=self.hits, misses=self.misses,
                        evictions=self.evictions,
                        entries=len(self._store), bytes=self._bytes)

    def labels(self) -> List[int]:
        """Distinct cached labels, least-recently-used first."""
        with self._lock:
            seen = dict.fromkeys(k[0] for k in self._store)
            return list(seen)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
