"""Lazy, cached EngineKey -> SamplingEngine construction.

The registry is the only place the serving layer touches engine
construction: a factory callback builds one
:class:`~repro_torch.sampling.SamplingEngine` (on its device) per
:class:`~repro_torch.serving.EngineKey` the first time traffic routes to
it, and the instance is cached for the registry's lifetime — so the
batcher and loop only ever ROUTE requests; they never see devices or
denoiser parameters.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from repro_torch.obs import Observability
from repro_torch.sampling.engine import SamplingEngine
from repro_torch.sampling.types import SampleRequest, WarmStart
from repro_torch.serving.cache import TrajectoryCache
from repro_torch.serving.queue import EngineKey

__all__ = ["EngineRegistry", "TrajectoryCache"]


class EngineRegistry:
    """One lazily-constructed :class:`SamplingEngine` per :class:`EngineKey`,
    plus that key's :class:`TrajectoryCache`.

    factory: ``EngineKey -> SamplingEngine``; called at most once per key
             (under a lock — two threads must not build one key's engine
             twice).
    """

    def __init__(self, factory: Callable[[EngineKey], SamplingEngine], *,
                 cache_capacity: int = 64,
                 cache_max_bytes: Optional[int] = None,
                 cache_neighborhood: float = 0.0):
        self._factory = factory
        self._lock = threading.Lock()
        self._engines: Dict[EngineKey, SamplingEngine] = {}
        self._caches: Dict[EngineKey, TrajectoryCache] = {}
        self._cache_capacity = cache_capacity
        self._cache_max_bytes = cache_max_bytes
        self._cache_neighborhood = cache_neighborhood
        self._obs: Optional[Observability] = None

    def bind_obs(self, obs: Observability) -> None:
        """Attach one shared observability bundle: every engine and
        trajectory cache constructed so far (and every future one) mirrors
        its stats into ``obs.metrics`` under its key's label and emits
        spans on ``obs.tracer``.  The :class:`~repro_torch.serving.ServingLoop`
        calls this with its own bundle at construction."""
        with self._lock:
            self._obs = obs
            engines = list(self._engines.items())
            caches = list(self._caches.items())
        for key, engine in engines:
            engine.bind_obs(obs, name=key.describe())
        for key, cache in caches:
            cache.bind_metrics(obs.metrics, name=key.describe())

    def get(self, key: EngineKey) -> SamplingEngine:
        with self._lock:
            engine = self._engines.get(key)
            if engine is None:
                engine = self._engines[key] = self._factory(key)
                if self._obs is not None:
                    engine.bind_obs(self._obs, name=key.describe())
            return engine

    def replace(self, key: EngineKey, engine: SamplingEngine) -> None:
        """Swap in a replacement engine for ``key`` — the elastic-recovery
        path: after device loss the supervisor builds a fresh engine on the
        surviving sub-mesh and installs it here, so every later
        ``get(key)`` routes to it.  The replacement joins the shared
        observability bundle like a factory-built engine."""
        with self._lock:
            self._engines[key] = engine
            obs = self._obs
        if obs is not None:
            engine.bind_obs(obs, name=key.describe())

    def set_factory(self,
                    factory: Callable[[EngineKey], SamplingEngine]) -> None:
        """Replace the construction callback for keys not yet built: after
        an elastic rebuild, NEW keys come up on the surviving sub-mesh."""
        with self._lock:
            self._factory = factory

    def engines(self) -> Dict[EngineKey, SamplingEngine]:
        """Snapshot of the engines constructed so far."""
        with self._lock:
            return dict(self._engines)

    def cache(self, key: EngineKey) -> TrajectoryCache:
        """``key``'s trajectory cache (lazy, one per key like its engine)."""
        with self._lock:
            cache = self._caches.get(key)
            if cache is None:
                cache = self._caches[key] = TrajectoryCache(
                    self._cache_capacity,
                    max_bytes=self._cache_max_bytes,
                    neighborhood=self._cache_neighborhood)
                if self._obs is not None:
                    cache.bind_metrics(self._obs.metrics,
                                       name=key.describe())
            return cache

    # -- RequestQueue submit-time hooks --------------------------------------

    def validate_submit(self, request: SampleRequest,
                        key: EngineKey) -> None:
        """``RequestQueue(validate=...)`` hook: raise exactly what a
        dispatch carrying ``request`` would raise — including warm-start
        shape/dtype mismatches against ``key``'s engine geometry — so a
        bad request fails its one ticket at submit time instead of
        poisoning a packed dispatch at trace time."""
        self.get(key).validate_request(request)

    def warm_start_for(self, request: SampleRequest,
                       key: EngineKey) -> Optional[WarmStart]:
        """``RequestQueue(warm_start=...)`` hook: the Sec 4.2 cache
        auto-population point.  A request that already carries an ``init``
        keeps it; otherwise the key's cache answers with its best match
        (exact (label, seed) -> same label -> neighborhood), or None for a
        cold start."""
        if request.init is not None:
            return None
        return self.cache(key).lookup(request.label, seed=request.seed)

    def warmup(self, key: EngineKey, *, slots: int,
               request: Optional[SampleRequest] = None,
               chunk_iters: int = 0) -> SamplingEngine:
        """Construct ``key``'s engine and run it once ahead of traffic.

        Dispatches one throwaway request at ``slots`` — the SERVING slot
        geometry (``Batcher.slots_for(engine)``) — so the one-time costs of
        a first solve land here and not on the first real request: on the
        card, the kernels' ``nvcc`` build at first use, library handles and
        the first dispatch's lazily loaded kernels.  Then rewinds the
        engine's serving counters (``stepwise_traces`` is kept).

        With ``chunk_iters > 0`` the stepwise protocol is warmed instead
        (open/init/merge/step/gather at the serving slot geometry and chunk
        size — what an iteration-level
        :class:`~repro_torch.serving.ServingLoop` drives); the throwaway
        bank is discarded.
        """
        engine = self.get(key)
        if chunk_iters:
            bank = engine.stepwise_open(slots, chunk_iters=chunk_iters)
            engine.stepwise_refill(bank, [0], [request or SampleRequest()])
            while bank.occupied:
                engine.stepwise_step(bank)
                engine.stepwise_harvest(bank)
        else:
            pending = engine.dispatch([request or SampleRequest()],
                                      slots=slots)
            engine.collect(pending)
        engine.reset_stats()
        return engine

    def __contains__(self, key: EngineKey) -> bool:
        with self._lock:
            return key in self._engines

    def __len__(self) -> int:
        with self._lock:
            return len(self._engines)

    def describe(self) -> str:
        lines = []
        for key, engine in sorted(self.engines().items()):
            lines.append(f"{key.describe()}: {engine.device}, "
                         f"{engine.stats['batches']} batch(es)")
        return "\n".join(lines) or "(no engines constructed)"
