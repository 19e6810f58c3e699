"""Typed, thread-safe metrics registry for the serving stack.

One :class:`MetricsRegistry` holds every instrument the serving layers
register — the engine, ``LaneBank`` (via the engine's counters), the
``ServingLoop``, ``RequestQueue``, ``Batcher``, and ``TrajectoryCache`` all
write into the same registry when wired through one
:class:`~repro_torch.obs.Observability` — so a single ``snapshot()`` answers
"what did this process do" and ``delta(prev)`` answers "what did it do
since the last look".

Three instrument types, each supporting label sets (labels are passed as
keyword arguments on every update; each distinct label set is its own
series):

  * :class:`Counter`   — monotonically increasing event counts
                         (``inc(amount)``);
  * :class:`Gauge`     — point-in-time values that move both ways
                         (``set``/``add``);
  * :class:`Histogram` — value distributions (``observe``) with fixed
                         bucket bounds, count/sum/min/max, and
                         bucket-interpolated percentile estimates.

:class:`StatsView` is the backward-compatibility bridge: a ``dict``
subclass that behaves exactly like the ad-hoc ``stats`` dicts the engine
and loop have always exposed (item access, ``+=``, ``update``, ``repr``,
equality, JSON serialization) while mirroring every write into registry
gauges — so ``engine.stats["blocking_polls"]`` keeps working verbatim and
the same number is queryable as ``engine.blocking_polls`` in a snapshot.
The mirror direction is dict -> registry: the dict stays the source of
truth, so no existing test or benchmark changes behavior.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView"]


def _label_key(labels: Dict) -> str:
    """Canonical series key for one label set ('' = unlabeled)."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class _Metric:
    """Shared per-series storage + locking for all instrument types."""

    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[str, object] = {}

    def series(self) -> Dict[str, object]:
        """Snapshot of every (label-key -> value) series."""
        with self._lock:
            return {k: self._export(v) for k, v in self._series.items()}

    def _export(self, value):
        return value


class Counter(_Metric):
    """Monotonic event counter (per label set)."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Point-in-time value (per label set); moves both ways."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = value

    def add(self, amount: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


#: default histogram bounds: sub-millisecond spans through minutes-long
#: drains AND small counts (rounds, iterations) share one geometric ladder
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
    10.0, 30.0, 100.0, 300.0, 1000.0)


class Histogram(_Metric):
    """Bucketed value distribution (per label set).

    Tracks exact count/sum/min/max plus per-bucket counts against fixed
    upper bounds (an implicit +inf bucket catches the tail), so
    :meth:`percentile` answers p50/p95-style questions with
    linear-in-bucket interpolation — bounded memory no matter how many
    observations land.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name} needs >= 1 bucket")

    def _fresh(self):
        return dict(count=0, sum=0.0, min=math.inf, max=-math.inf,
                    bucket_counts=[0] * (len(self.buckets) + 1))

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._fresh()
            s["count"] += 1
            s["sum"] += value
            s["min"] = min(s["min"], value)
            s["max"] = max(s["max"], value)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    s["bucket_counts"][i] += 1
                    break
            else:
                s["bucket_counts"][-1] += 1

    def _quantile(self, s: Dict, q: float) -> float:
        rank = q * s["count"]
        seen = 0.0
        for i, n in enumerate(s["bucket_counts"]):
            if not n:
                continue
            if seen + n >= rank:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i] if i < len(self.buckets) \
                    else s["max"]
                frac = (rank - seen) / n
                est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return min(max(est, s["min"]), s["max"])
            seen += n
        return s["max"]

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Bucket-interpolated ``q``-quantile (q in [0, 1]); None when the
        series has no observations.  Clamped into [min, max] so a lone
        observation answers itself, not its bucket's upper bound."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if not s or not s["count"]:
                return None
            return self._quantile(s, q)

    def _summarize(self, s: Dict) -> Dict:
        return dict(count=s["count"], sum=s["sum"], min=s["min"],
                    max=s["max"], p50=self._quantile(s, 0.50),
                    p95=self._quantile(s, 0.95))

    def summary(self, **labels) -> Optional[Dict]:
        with self._lock:
            s = self._series.get(_label_key(labels))
            if not s or not s["count"]:
                return None
            return self._summarize(s)

    def merged(self) -> Optional[Dict]:
        """Summary over EVERY label set merged into one distribution
        (bucket counts add, min/max extremize) — the whole-process answer
        when each series carries its own ``key=`` label."""
        with self._lock:
            live = [s for s in self._series.values() if s["count"]]
            if not live:
                return None
            m = self._fresh()
            for s in live:
                m["count"] += s["count"]
                m["sum"] += s["sum"]
                m["min"] = min(m["min"], s["min"])
                m["max"] = max(m["max"], s["max"])
                m["bucket_counts"] = [
                    a + b for a, b in zip(m["bucket_counts"],
                                          s["bucket_counts"])]
            return self._summarize(m)

    def _export(self, s):
        return dict(count=s["count"], sum=s["sum"], min=s["min"],
                    max=s["max"], bucket_counts=list(s["bucket_counts"]))


class MetricsRegistry:
    """Thread-safe instrument registry.

    ``counter``/``gauge``/``histogram`` create-or-return the named
    instrument (re-registering a name under a different type is an error —
    a silent type change would corrupt dashboards).  ``snapshot()`` walks
    every series; ``delta(prev)`` subtracts a previous snapshot so callers
    can meter an interval without resetting anything.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(metric, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{metric.kind}, not {cls.kind}")
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict]:
        """``{metric_name: {label_key: value | histogram_dict}}``."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.series() for m in metrics}

    def delta(self, prev: Dict[str, Dict]) -> Dict[str, Dict]:
        """Current snapshot minus ``prev`` (a prior ``snapshot()``).

        Scalars subtract; histogram exports subtract field-wise (min/max
        are NOT interval-scoped, so they pass through current values).
        Series absent from ``prev`` report their full current value.
        """
        out: Dict[str, Dict] = {}
        for name, series in self.snapshot().items():
            prev_series = prev.get(name, {})
            out[name] = {key: _sub(value, prev_series.get(key))
                         for key, value in series.items()}
        return out


def _sub(cur, old):
    if old is None:
        return cur
    if isinstance(cur, dict):
        out = dict(cur)
        for field in ("count", "sum"):
            if field in out and field in old:
                out[field] = out[field] - old[field]
        if "bucket_counts" in out and "bucket_counts" in old:
            out["bucket_counts"] = [c - o for c, o in
                                    zip(out["bucket_counts"],
                                        old["bucket_counts"])]
        return out
    return cur - old


class StatsView(dict):
    """A ``stats`` dict that mirrors every write into registry gauges.

    Drop-in replacement for the serving layers' ad-hoc ``stats`` dicts:
    it IS a dict (same repr/equality/iteration/JSON behavior), so every
    existing ``stats["key"] += 1`` call site and test assertion keeps
    working — but each write also lands in ``registry.gauge(f"{scope}.
    {key}")`` under this view's label set, unifying the scattered
    counters into one queryable registry.  ``rebind`` re-homes the view
    onto a shared registry (``EngineRegistry`` does this when an
    :class:`~repro_torch.obs.Observability` is attached after engine
    construction), replaying current values so the new registry starts
    consistent.
    """

    def __init__(self, registry: MetricsRegistry, scope: str,
                 labels: Optional[Dict] = None, initial: Optional[Dict] = None):
        super().__init__()
        self._registry = registry
        self._scope = scope
        self._labels = dict(labels or {})
        for k, v in (initial or {}).items():
            self[k] = v

    def _mirror(self, key, value) -> None:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            self._registry.gauge(f"{self._scope}.{key}").set(
                value, **self._labels)

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self._mirror(key, value)

    def update(self, *args, **kw) -> None:   # dict.update bypasses
        for k, v in dict(*args, **kw).items():  # __setitem__; route it back
            self[k] = v

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return super().__getitem__(key)

    def rebind(self, registry: MetricsRegistry,
               labels: Optional[Dict] = None) -> None:
        """Point the mirror at a (shared) registry and replay the current
        values into it."""
        self._registry = registry
        if labels is not None:
            self._labels = dict(labels)
        for k, v in self.items():
            self._mirror(k, v)
