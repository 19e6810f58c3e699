"""Port parity for the serving stack on one device (``repro_torch.serving``):
the same scripted traffic through the JAX package's stack and the port's,
driven synchronously (``drain``/``pump``) on a fake clock so both take the
same decisions — queue priority, deadlines and timeouts, the lazy registry
and warmup, the batcher's fill / deadline / flush and ``plan_refill``, the
trajectory cache, whole-batch and stepwise loops, two-tier refine with
preemption, a poisoned key — then threaded live arrivals, out-of-order
collection through ``PendingBatch.ready()``, and ``serve.py
--serve-async`` on the CPU."""
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro import sampling as jsampling
from repro import serving as jserving
from repro_torch import sampling as tsampling
from repro_torch import serving as tserving
from repro_torch.sampling.engine import PendingBatch
from tests.test_torch_helpers import assert_same_result, label_factories

D = 24
N_LABELS = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FACTORY, TORCH_FACTORY = label_factories(D, N_LABELS)
STACKS = {"jax": (jserving, jsampling, JAX_FACTORY),
          "torch": (tserving, tsampling, TORCH_FACTORY)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def both(fn):
    """``fn(serving, sampling, factory)`` on each stack -> {name: result}."""
    return {name: fn(*stack) for name, stack in STACKS.items()}


def _key(serving, T=8, solver="taa"):
    return serving.EngineKey("oracle", T, solver)


def _request(sampling, kw):
    kw = dict(kw)
    if "init" in kw:
        traj, t_init = kw["init"]
        kw["init"] = sampling.WarmStart(traj, t_init=t_init)
    return sampling.SampleRequest(**kw)


def _served(tickets):
    return [t.result(timeout=0) for t in tickets]


def _assert_same_tickets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_result(g, w)


# --- queue ------------------------------------------------------------------

def test_queue_priority_deadlines_and_timeouts():
    def run(serving, sampling, factory):
        clock = FakeClock(100.0)
        q = serving.RequestQueue(clock=clock)
        key = _key(serving)
        q.submit(sampling.SampleRequest(seed=1), key)
        clock.t = 101.0
        q.submit(sampling.SampleRequest(seed=2), key)
        q.submit(sampling.SampleRequest(seed=3, priority=5), key)
        pre = q.submit(sampling.SampleRequest(seed=4, arrival_time=42.0), key)
        order = [t.request.seed for t in q.pop(key, 4)]
        # deadline promotion: the overdue low-priority ticket leads
        clock.t = 0.0
        q.submit(sampling.SampleRequest(seed=5), key)
        clock.t = 100.0
        for seed in range(6, 10):
            q.submit(sampling.SampleRequest(seed=seed, priority=5), key)
        promoted = [t.request.seed for t in q.pop(key, 4,
                                                   promote_before=50.0)]
        rest = [t.request.seed for t in q.pop(key, 4)]
        # a queued request past its timeout_s fails at the next pump
        loop = serving.ServingLoop(
            serving.EngineRegistry(factory), q,
            serving.Batcher(serving.BatchingPolicy(max_batch=2)))
        late = q.submit(sampling.SampleRequest(seed=11, timeout_s=1.0), key)
        clock.t = 105.0
        loop.pump()
        with pytest.raises(TimeoutError, match="expired"):
            late.result(timeout=0)
        q.close(RuntimeError("loop died"))
        stranded = q.submit(sampling.SampleRequest(seed=12), key)
        with pytest.raises(RuntimeError, match="loop died"):
            stranded.result(timeout=0)
        return (order, pre.request.arrival_time, promoted, rest,
                dict(loop.stats), len(q))

    got = both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [3, 1, 2, 4]
    assert got["torch"][2] == [5, 6, 7, 8]
    assert got["torch"][4]["failed"] == 1


# --- registry ---------------------------------------------------------------

@pytest.mark.parametrize("chunk_iters", [0, 2])
def test_registry_is_lazy_and_warmup_keeps_no_traffic(chunk_iters):
    def run(serving, sampling, factory):
        counts = {}

        def counted(key):
            counts[key] = counts.get(key, 0) + 1
            return factory(key)

        registry = serving.EngineRegistry(counted)
        k1, k2 = _key(serving), _key(serving, solver="fp")
        assert len(registry) == 0 and k1 not in registry
        engine = registry.warmup(k1, slots=2, chunk_iters=chunk_iters)
        assert registry.get(k1) is engine
        registry.get(k2)
        assert "oracle/T8/taa" in registry.describe()
        stats = {k: engine.stats[k] for k in
                 ("batches", "requests", "blocking_polls",
                  "host_fetch_bytes", "gather_launches", "stepwise_traces")}
        return sorted(c for c in counts.values()), len(registry), stats

    got = both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][2]["stepwise_traces"] == (5 if chunk_iters else 0)
    assert got["torch"][2]["batches"] == 0


# --- batcher ----------------------------------------------------------------

def test_batcher_fill_deadline_flush_and_plan_refill():
    def run(serving, sampling, factory):
        clock = FakeClock(0.0)
        q = serving.RequestQueue(clock=clock)
        registry = serving.EngineRegistry(factory)
        key = _key(serving)
        strict = serving.Batcher(serving.BatchingPolicy(
            max_batch=4, max_wait_s=10.0, work_conserving=False))
        out = []
        q.submit(sampling.SampleRequest(seed=1), key)
        q.submit(sampling.SampleRequest(seed=2), key)
        out.append(strict.plan(q, registry, now=1.0, idle=True))
        out.append(strict.plan(q, registry, now=10.0))
        clock.t = 10.4
        for seed in range(3, 8):
            q.submit(sampling.SampleRequest(seed=seed), key)
        out.append(strict.plan(q, registry, now=10.5))
        out.append(strict.plan(q, registry, now=10.5, flush=True))
        wc = serving.Batcher(serving.BatchingPolicy(max_batch=4,
                                                    max_wait_s=10.0))
        q.submit(sampling.SampleRequest(seed=8), key)
        out.append(wc.plan(q, registry, now=10.6, idle=True))
        plans = [[(len(d.tickets), d.slots,
                   [t.request.seed for t in d.tickets]) for d in p]
                 for p in out]
        # iteration-level admission
        refills = [wc.plan_refill(q, key, 2, now=11.0, active=True)]
        q.submit(sampling.SampleRequest(seed=9), key)
        refills.append(wc.plan_refill(q, key, 4, now=11.1, active=False))
        refills.append(wc.plan_refill(q, key, 4, now=22.0, active=False))
        for seed in (10, 11):
            q.submit(sampling.SampleRequest(seed=seed), key)
        refills.append(wc.plan_refill(q, key, 2, now=22.1, active=False))
        q.submit(sampling.SampleRequest(seed=12), key)
        refills.append(wc.plan_refill(q, key, 0, now=22.2, active=True,
                                      flush=True))
        refills.append(wc.plan_refill(q, key, 4, now=22.2, active=False,
                                      flush=True))
        refills.append(strict.plan_refill(q, key, 4, now=22.3, active=True))
        wc.note(key, dict(slot_utilization=0.5, wall_s=1.0, pack_s=0.1))
        wc.note(key, dict(slot_utilization=1.0, wall_s=3.0, pack_s=0.3))
        return plans, [[t.request.seed for t in r] for r in refills], \
            wc.observed(key), wc.slots_for(registry.get(key))

    got = both(run)
    assert got["torch"] == got["jax"]
    plans = got["torch"][0]
    assert plans[0] == [] and plans[1] == [(2, 4, [1, 2])]
    assert got["torch"][1] == [[], [], [9], [10, 11], [], [12], []]
    assert got["torch"][3] == 4


def test_policy_and_loop_validation():
    with pytest.raises(ValueError, match="max_batch"):
        tserving.BatchingPolicy(max_batch=0)
    with pytest.raises(ValueError, match="target_util"):
        tserving.BatchingPolicy(target_util=1.5)
    registry = tserving.EngineRegistry(TORCH_FACTORY)
    with pytest.raises(ValueError, match="depth"):
        tserving.ServingLoop(registry, tserving.RequestQueue(), depth=0)
    with pytest.raises(ValueError, match="refiner requires"):
        tserving.ServingLoop(registry, tserving.RequestQueue(),
                             refiner=tserving.RefinePlanner())


# --- trajectory cache ---------------------------------------------------------

def _solved(sampling, label, seed, n=8):
    value = label if isinstance(label, (int, float)) else 0.0
    return SimpleNamespace(
        request=sampling.SampleRequest(label=label, seed=seed),
        trajectory=np.full((n,), value, np.float32),     # 4*n bytes
        converged=True, early_stopped=False)


def test_trajectory_cache_lru_bytes_and_neighbourhood():
    def run(serving, sampling, factory):
        out = []
        cache = serving.TrajectoryCache(capacity=8, max_bytes=3 * 32)
        for label, seed in ((0, 1), (1, 2), (2, 3), (3, 4)):
            out.append(cache.record(_solved(sampling, label, seed)))
        out.append(cache.lookup(0))
        out.append(cache.lookup(1, seed=2) is not None)
        out.append(cache.record(_solved(sampling, 4, 5)))
        out.append((cache.lookup(1) is not None, cache.lookup(2)))
        out.append(cache.record(_solved(sampling, 5, 6, n=100)))
        out.append(cache.stats())
        near = serving.TrajectoryCache(capacity=8, neighborhood=2)
        for label, seed in ((0, 1), (5, 2), (5, 9), ("cat", 3)):
            near.record(_solved(sampling, label, seed))
        for label, seed in ((4, None), (1, None), (8, None), (5, 2),
                            (5, 404), ("cat", None), ("dog", None)):
            ws = near.lookup(label, seed=seed)
            out.append(None if ws is None else float(ws.trajectory[0]))
        out.append((near.stats(), near.labels()))
        return out

    got = both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][-1][0]["hits"] == 5


# --- loops: whole-batch and stepwise ------------------------------------------

def _mixed_specs(serving, factory, T):
    [solved] = factory(_key(serving, T)).run_batch(
        [_request(STACKS["jax"][1], dict(label=1, seed=3))])
    specs = [dict(label=i % N_LABELS, seed=50 + i) for i in range(6)]
    specs[1] = dict(label=3, seed=51, tau=5e-2)
    specs[2] = dict(label=1, seed=3,
                    init=(np.asarray(solved.trajectory), T // 2))
    specs[4] = dict(label=0, seed=54, quality_steps=3)
    specs[5] = dict(label=2, seed=55, max_iters=2)
    return specs


REPORT_KEYS = ("blocking_polls", "gather_launches", "harvests", "refills",
               "completed", "device_iters", "host_fetch_bytes",
               "update_launches", "useful_iters", "slots", "occupied")


@pytest.mark.parametrize("chunk_iters", [0, 2])
def test_loop_matches_jax_with_mixed_budgets(chunk_iters):
    """Whole-batch and stepwise serving over cold, warm-start, loose-tau,
    quality-steps and max_iters requests: the same results, the same loop
    stats, and (stepwise) the same bank reports."""
    T = 12
    specs = _mixed_specs(jserving, JAX_FACTORY, T)

    def run(serving, sampling, factory):
        registry = serving.EngineRegistry(factory)
        queue = serving.RequestQueue(clock=FakeClock())
        loop = serving.ServingLoop(
            registry, queue, serving.Batcher(serving.BatchingPolicy(
                max_batch=4)), chunk_iters=chunk_iters)
        key = _key(serving, T)
        tickets = [queue.submit(_request(sampling, kw), key)
                   for kw in specs]
        loop.drain()
        reports = {k.describe(): {n: r[n] for n in REPORT_KEYS}
                   for k, r in loop.bank_reports().items()} \
            if chunk_iters else {}
        engine = registry.get(key)
        return _served(tickets), dict(loop.stats), reports, \
            engine.stats["stepwise_traces"], engine.stats["update_launches"]

    got = both(run)
    _assert_same_tickets(got["torch"][0], got["jax"][0])
    assert got["torch"][1:] == got["jax"][1:]
    assert got["torch"][1]["completed"] == 6
    if chunk_iters:
        assert got["torch"][3] == 5
        assert got["torch"][1]["refills"] >= 2
    # the port's served results equal its own run_batch at the same slots
    ref = TORCH_FACTORY(_key(tserving, T)).run_batch(
        [_request(tsampling, kw) for kw in specs], batch_size=4)
    _assert_same_tickets(got["torch"][0], ref)


def test_stepwise_seq_key_chunks_and_fails_only_the_bad_ticket():
    def run(serving, sampling, factory):
        registry = serving.EngineRegistry(factory)
        queue = serving.RequestQueue(clock=FakeClock())
        loop = serving.ServingLoop(
            registry, queue, serving.Batcher(serving.BatchingPolicy(
                max_batch=2)), chunk_iters=3)
        key = _key(serving, 10, "seq")
        bad = queue.submit(sampling.SampleRequest(seed=1, tau=1e-2), key)
        tickets = [queue.submit(sampling.SampleRequest(label=i, seed=20 + i),
                                key) for i in range(3)]
        loop.drain()
        with pytest.raises(ValueError, match="solver-iteration budgets"):
            bad.result(timeout=0)
        return _served(tickets), dict(loop.stats)

    got = both(run)
    _assert_same_tickets(got["torch"][0], got["jax"][0])
    assert got["torch"][1] == got["jax"][1]
    assert all(r.iters == 10 for r in got["torch"][0])


def test_cache_warm_starts_and_submit_time_validation():
    def run(serving, sampling, factory):
        T = 10
        key = _key(serving, T)
        registry = serving.EngineRegistry(factory)
        queue = serving.RequestQueue(clock=FakeClock(),
                                     validate=registry.validate_submit,
                                     warm_start=registry.warm_start_for)
        errors = []
        for init in (sampling.WarmStart(np.zeros((3, D), np.float32)),
                     sampling.WarmStart(np.zeros((T + 1, D), np.float32),
                                        t_init=T + 3),
                     sampling.WarmStart(np.zeros((T + 1, D), np.int32))):
            bad = queue.submit(sampling.SampleRequest(label=1, seed=2,
                                                      init=init), key)
            with pytest.raises(ValueError) as err:
                bad.result(timeout=0)
            errors.append(str(err.value).split(" ")[0:3])
        loop = serving.ServingLoop(
            registry, queue, serving.Batcher(serving.BatchingPolicy(
                max_batch=2)), chunk_iters=2, cache=True)
        cold = queue.submit(sampling.SampleRequest(label=1, seed=7), key)
        loop.drain()
        warm = queue.submit(sampling.SampleRequest(label=1, seed=7), key)
        other = queue.submit(sampling.SampleRequest(label=3, seed=8), key)
        assert warm.request.init is not None and other.request.init is None
        loop.drain()
        return errors, _served([cold, warm, other]), \
            registry.cache(key).stats(), dict(loop.stats)

    got = both(run)
    assert got["torch"][0] == got["jax"][0]
    _assert_same_tickets(got["torch"][1], got["jax"][1])
    assert got["torch"][2:] == got["jax"][2:]
    assert got["torch"][1][1].iters <= got["torch"][1][0].iters


def test_two_tier_refine_and_preemption():
    """Drafts resolve their draft stage; warm-started preemptible
    continuations occupy both lanes; urgent arrivals preempt them; every
    ticket ends at full tolerance — with the same decisions on both
    stacks."""
    def run(serving, sampling, factory):
        T = 16
        key = _key(serving, T)
        registry = serving.EngineRegistry(factory)
        queue = serving.RequestQueue(clock=FakeClock())
        loop = serving.ServingLoop(
            registry, queue, serving.Batcher(serving.BatchingPolicy(
                max_batch=2)), chunk_iters=1,
            refiner=serving.RefinePlanner(serving.RefinePolicy()))
        drafts = [queue.submit(sampling.SampleRequest(
            label=i, seed=10 + i, quality_steps=1), key) for i in range(2)]
        pumps = 0
        while not (all(t.draft_done() for t in drafts)
                   and queue.pending(key) == 0 and loop.inflight == 2):
            loop.pump(flush=True)
            pumps += 1
            assert pumps < 50
        urgent = [queue.submit(sampling.SampleRequest(label=2 + i,
                                                      seed=20 + i), key)
                  for i in range(2)]
        loop.pump(flush=True)
        preempted = loop.stats["preemptions"]
        loop.drain()
        draft_results = [t.draft_result(timeout=0) for t in drafts]
        return (pumps, preempted, _served(drafts + urgent), draft_results,
                dict(loop.stats), [t.refines for t in drafts],
                registry.get(key).stats["stepwise_traces"])

    got = both(run)
    _assert_same_tickets(got["torch"][2], got["jax"][2])
    _assert_same_tickets(got["torch"][3], got["jax"][3])
    for i in (0, 1, 4, 5, 6):
        assert got["torch"][i] == got["jax"][i], i
    assert got["torch"][1] >= 1 and got["torch"][6] == 5
    assert all(r.converged for r in got["torch"][2])
    assert all(r.early_stopped for r in got["torch"][3])


def test_poisoned_key_fails_its_tickets_and_serving_continues():
    def run(serving, sampling, factory):
        registry = serving.EngineRegistry(factory)
        queue = serving.RequestQueue(clock=FakeClock())
        loop = serving.ServingLoop(
            registry, queue, serving.Batcher(serving.BatchingPolicy(
                max_batch=2)))
        bad = queue.submit(sampling.SampleRequest(seed=1),
                           _key(serving, solver="nope"))
        good = queue.submit(sampling.SampleRequest(seed=2), _key(serving))
        loop.drain()
        with pytest.raises(KeyError, match="nope"):
            bad.result(timeout=0)
        return _served([good]), len(queue)

    got = both(run)
    _assert_same_tickets(got["torch"][0], got["jax"][0])
    assert got["torch"][1] == got["jax"][1] == 0


# --- threads ------------------------------------------------------------------

@pytest.mark.parametrize("chunk_iters", [0, 2])
def test_threaded_live_arrivals(chunk_iters):
    """A background loop serves live arrivals: the same results as the
    JAX stack's, every ticket completed, none failed."""
    def run(serving, sampling, factory):
        key = _key(serving)
        registry = serving.EngineRegistry(factory)
        registry.warmup(key, slots=4, chunk_iters=chunk_iters)
        queue = serving.RequestQueue()
        loop = serving.ServingLoop(
            registry, queue, serving.Batcher(serving.BatchingPolicy(
                max_batch=4, max_wait_s=0.01)), chunk_iters=chunk_iters)
        with loop:
            tickets = []
            for i in range(6):
                tickets.append(queue.submit(sampling.SampleRequest(
                    label=i % N_LABELS, seed=90 + i), key))
                time.sleep(0.002)
            results = [t.result(timeout=120) for t in tickets]
        with pytest.raises(RuntimeError, match="background thread"):
            with loop:
                loop.pump()
        return results, (loop.stats["completed"], loop.stats["failed"],
                         len(queue), loop.inflight)

    got = both(run)
    _assert_same_tickets(got["torch"][0], got["jax"][0])
    assert got["torch"][1] == got["jax"][1] == (6, 0, 0, 0)


def test_concurrent_submitters_are_all_served():
    """More client threads than cores submit at once to a background
    stepwise loop, with a short switch interval: every ticket resolves,
    none twice, and the loop's counters add up."""
    key = _key(tserving, T=6)
    registry = tserving.EngineRegistry(TORCH_FACTORY)
    queue = tserving.RequestQueue()
    loop = tserving.ServingLoop(
        registry, queue, tserving.Batcher(tserving.BatchingPolicy(
            max_batch=4, max_wait_s=0.001)), chunk_iters=2)
    n_threads, per_thread = min(2 * (os.cpu_count() or 4), 64), 2
    tickets, lock = [], threading.Lock()

    def client(i):
        for j in range(per_thread):
            t = queue.submit(tsampling.SampleRequest(
                label=(i + j) % N_LABELS, seed=1000 + per_thread * i + j),
                key)
            with lock:
                tickets.append(t)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with loop:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            results = [t.result(timeout=120) for t in tickets]
    finally:
        sys.setswitchinterval(interval)
    n = n_threads * per_thread
    assert len(tickets) == len({t.seqno for t in tickets}) == n
    assert all(r.converged for r in results)
    assert [r.request.seed for r in results] == \
        [t.request.seed for t in tickets]
    assert loop.stats["completed"] == n and loop.stats["failed"] == 0
    assert registry.get(key).stats["stepwise_traces"] == 5


class _StubEvent:
    """Stands in for a dispatch's CUDA event: query()/synchronize()."""

    def __init__(self):
        self._done = threading.Event()

    def query(self):
        return self._done.is_set()

    def synchronize(self):
        self._done.wait()

    def finish(self):
        self._done.set()


class _StubEngine:
    """Engine double whose dispatches finish when the test says so."""

    def __init__(self):
        self.last_dispatches = []
        self.pendings = []

    def dispatch(self, requests, slots=None):
        pending = PendingBatch(trajs=None, info={}, requests=list(requests),
                               slots=slots or 1, diagnostics=False,
                               pack_s=0.0, t_dispatch=0.0, event=_StubEvent())
        self.pendings.append(pending)
        return pending

    def collect(self, pending):
        pending.event.synchronize()
        return [f"served-{r.seed}" for r in pending.requests]


def _wait_for(cond):
    deadline = time.monotonic() + 30
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.001)
    assert cond()


def test_ready_batches_collect_out_of_order():
    """A short batch that finishes behind a long one resolves first: the
    loop asks ``PendingBatch.ready()`` (the dispatch's event) instead of
    waiting for the device."""
    engines = {}

    class StubRegistry:
        def get(self, key):
            return engines.setdefault(key, _StubEngine())

    slow_key = tserving.EngineKey("stub", 10, "taa")
    fast_key = tserving.EngineKey("stub", 4, "taa")
    queue = tserving.RequestQueue()
    loop = tserving.ServingLoop(
        StubRegistry(), queue,
        tserving.Batcher(tserving.BatchingPolicy(max_batch=2,
                                                 max_wait_s=0.001)))
    with loop:
        slow = [queue.submit(tsampling.SampleRequest(seed=s), slow_key)
                for s in (1, 2)]
        _wait_for(lambda: slow_key in engines and engines[slow_key].pendings)
        fast = queue.submit(tsampling.SampleRequest(seed=3), fast_key)
        _wait_for(lambda: fast_key in engines and engines[fast_key].pendings)
        engines[fast_key].pendings[0].event.finish()
        assert fast.result(timeout=30) == "served-3"
        assert not slow[0].done()
        engines[slow_key].pendings[0].event.finish()
        assert [t.result(timeout=30) for t in slow] == \
            ["served-1", "served-2"]
    assert loop.stats["completed"] == 3


def test_cpu_dispatch_is_ready_and_collect_waits_on_its_event(monkeypatch):
    """On the CPU a dispatch has no event and is ready at once; collect
    never waits for the whole device."""
    import torch

    def forbidden(*a, **k):
        raise AssertionError("collect synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    engine = TORCH_FACTORY(_key(tserving))
    pending = engine.dispatch([tsampling.SampleRequest(seed=1)], slots=2)
    assert pending.event is None and pending.ready()
    [res] = engine.collect(pending)
    assert res.converged and engine.stats["batches"] == 1


def test_serve_async_cli_serves_every_ticket(tmp_path):
    trace = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve-async",
         "--smoke", "--device", "cpu", "--requests", "6", "--steps-T", "8",
         "--chunk-iters", "2", "--batch-size", "2", "--loose-tau-frac",
         "0.5", "--refine", "--cache", "--trace-out", str(trace)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "async served 6 requests" in out
    assert "'completed': 6, 'failed': 0" in out
    assert "every stage resolved" in out and trace.exists()
