"""Port parity for ``repro_torch.obs``: the same operations on the JAX
package's metrics registry, StatsView, span tracer and convergence
recorder and on the port's give the same snapshots, deltas, events and
curves; a traced drain through both serving stacks gives the same span
names and counts and changes no protocol counter and no bit of the port's
solves; the engine's injectable clock; and ``tools/obs_report.py`` reads
the port's trace."""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import obs as jobs
from repro import sampling as jsampling
from repro import serving as jserving
from repro_torch import obs as tobs
from repro_torch import sampling as tsampling
from repro_torch import serving as tserving
from tests.test_torch_helpers import assert_same_result, label_factories

D = 24
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FACTORY, TORCH_FACTORY = label_factories(D)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def both(fn):
    return {"jax": fn(jobs), "torch": fn(tobs)}


def test_metrics_snapshot_and_delta_match():
    def run(obs):
        reg = obs.MetricsRegistry()
        reg.counter("served").inc()
        reg.counter("served").inc(2, key="a")
        with pytest.raises(ValueError):
            reg.counter("served").inc(-1)
        reg.gauge("depth").set(4)
        reg.gauge("depth").add(-1)
        h = reg.histogram("wait_s")
        for v in (0.01, 0.02, 0.02, 5.0, 2e3):
            h.observe(v, key="a")
        h.observe(0.02, key="b")
        before = reg.snapshot()
        reg.counter("served").inc(3, key="a")
        h.observe(0.5, key="a")
        reg.counter("new").inc(7)
        with pytest.raises(ValueError):
            reg.gauge("served")
        return (before, reg.snapshot(), reg.delta(before), h.summary(key="a"),
                h.merged(), h.percentile(0.95, key="b"), h.summary(),
                reg.names())

    got = both(run)
    assert got["torch"] == got["jax"]


def test_stats_view_mirrors_and_rebinds_alike():
    def run(obs):
        reg = obs.MetricsRegistry()
        stats = obs.StatsView(reg, "engine", labels={"engine": "k"},
                              initial={"batches": 0, "wall_s": 0.0})
        stats["batches"] += 2
        stats.update(requests=5)
        stats.setdefault("polls", 0)
        shared = obs.MetricsRegistry()
        stats.rebind(shared, labels={"engine": "k2"})
        stats["batches"] += 1
        return dict(stats), json.dumps(stats), reg.snapshot(), \
            shared.snapshot()

    got = both(run)
    assert got["torch"] == got["jax"]


def test_tracer_events_export_and_json_safe_match(tmp_path):
    def run(obs):
        clock = FakeClock(10.0)
        tracer = obs.SpanTracer(enabled=True, clock=clock)
        clock.t = 10.5
        with tracer.span("work", tid="engine-a", n=3):
            clock.t = 11.0
        tracer.async_begin("ticket", 7, key="k", ts_s=10.2, bad=float("nan"))
        tracer.async_begin("ticket", 7)
        tracer.async_instant("admit", 7)
        tracer.instant("mark", tid="engine-a", x=np.int32(2))
        tracer.async_end("ticket", 7, residual_curve=[
            dict(round=0, residual=np.float32(0.5)),
            dict(round=1, residual=float("inf"))])
        small = obs.SpanTracer(enabled=True, max_events=2)
        for i in range(5):
            small.instant(f"e{i}")
        off = obs.SpanTracer(enabled=False)
        with off.span("x"):
            pass
        path = tracer.export(tmp_path / f"{obs.__name__}.json")
        safe = obs.json_safe({"a": np.int32(3), "b": (np.float64(1.5),),
                              "c": np.array([1.0, float("nan")]),
                              "d": float("-inf")})
        return tracer.events(), json.loads(path.read_text()), \
            (len(small.events()), small.dropped, off.events()), safe

    got = both(run)
    assert got["torch"] == got["jax"]


class _T:
    def __init__(self, seqno):
        self.seqno = seqno
        self.residual_curve = None


def test_convergence_recorder_and_bundle_match():
    def run(obs):
        reg = obs.MetricsRegistry()
        rec = obs.ConvergenceRecorder(reg)
        t0, t1 = _T(0), _T(1)
        rec.observe_round("k", 0, [(0, t0), (1, t1)], dict(
            iters=np.array([2, 2]),
            residual=np.array([0.5, np.inf], np.float32)))
        rec.observe_round("k", 1, [(0, t0), (1, None)], dict(
            iters=np.array([4, 4]),
            residual=np.array([0.1, np.inf], np.float32)))
        curves = rec.finish(t0), rec.finish(t1)
        rec.observe_round("k", 2, [(0, _T(9))], dict(
            iters=np.array([1]), residual=np.array([1.0], np.float32)))
        rec.discard(_T(9))
        a, b = obs.Observability.off(), obs.Observability.off()
        a.metrics.counter("n").inc()
        modes = (obs.Observability.off().active,
                 obs.Observability.enabled().active,
                 b.metrics.counter("n").value())
        return curves, rec.open_curves(), reg.snapshot(), modes

    got = both(run)
    assert got["torch"] == got["jax"]


def test_engine_clock_times_dispatch_wall():
    clock = FakeClock(50.0)
    engine = TORCH_FACTORY(tserving.EngineKey("oracle", 6, "taa"),
                           clock=clock)
    pending = engine.dispatch([tsampling.SampleRequest(label=1, seed=1)],
                              slots=1)
    clock.t = 53.5
    engine.collect(pending)
    assert engine.stats["wall_s"] == pytest.approx(3.5)
    assert engine.last_dispatches[-1]["wall_s"] == pytest.approx(3.5)
    engine.MAX_DISPATCH_REPORTS = 2
    engine.run_batch([tsampling.SampleRequest(seed=i) for i in range(3)],
                     batch_size=1)
    assert len(engine.last_dispatches) == 2


def _traced_drain(serving, sampling, factory, obs, tmp_path=None):
    key = serving.EngineKey("oracle", 12, "taa")
    registry = serving.EngineRegistry(factory)
    queue = serving.RequestQueue(clock=FakeClock(), obs=obs)
    loop = serving.ServingLoop(
        registry, queue, serving.Batcher(serving.BatchingPolicy(max_batch=4)),
        chunk_iters=2, refiner=serving.RefinePlanner(
            serving.RefinePolicy(), metrics=obs.metrics), obs=obs)
    tickets = [queue.submit(sampling.SampleRequest(
        label=i % 4, seed=50 + i,
        **({} if i % 2 == 0 else dict(quality_steps=2))), key)
        for i in range(6)]
    loop.drain()
    results = [t.result(timeout=0) for t in tickets]
    report = loop.bank_reports()[key]
    engine = registry.get(key)
    return dict(results=results, tickets=tickets, report=report,
                loop=dict(loop.stats), engine=dict(engine.stats),
                name=key.describe())


def test_traced_drain_matches_jax_and_is_protocol_neutral(tmp_path):
    obs_j, obs_t = jobs.Observability.enabled(), tobs.Observability.enabled()
    traced_j = _traced_drain(jserving, jsampling, JAX_FACTORY, obs_j)
    traced_t = _traced_drain(tserving, tsampling, TORCH_FACTORY, obs_t)
    plain_t = _traced_drain(tserving, tsampling, TORCH_FACTORY,
                            tobs.Observability())

    def names(obs):
        return collections.Counter((e["name"], e["ph"])
                                   for e in obs.tracer.events())

    # the same spans, lifecycle markers and counts on both stacks
    assert names(obs_t) == names(obs_j)
    assert {"stepwise.open", "stepwise.step", "stepwise.poll",
            "stepwise.harvest", "stepwise.refill"} <= \
        {n for n, ph in names(obs_t) if ph == "X"}
    for t_t, t_j in zip(traced_t["tickets"], traced_j["tickets"]):
        assert len(t_t.residual_curve) == len(t_j.residual_curve) > 0
        assert [p["iters"] for p in t_t.residual_curve] == \
            [p["iters"] for p in t_j.residual_curve]
    for got, want in zip(traced_t["results"], traced_j["results"]):
        assert_same_result(got, want)
    assert traced_t["loop"] == traced_j["loop"]
    for k in ("blocking_polls", "gather_launches", "harvests",
              "host_fetch_bytes", "device_iters", "completed"):
        assert traced_t["report"][k] == traced_j["report"][k], k
    # metrics: one registry spans queue, loop and engine, as in the JAX one
    for metric, labels in (("queue.submitted", {"key": traced_t["name"]}),
                           ("refine.drafts", {"key": traced_t["name"]})):
        assert obs_t.metrics.counter(metric).value(**labels) == \
            obs_j.metrics.counter(metric).value(**labels) > 0
    assert obs_t.metrics.gauge("engine.stepwise_traces").value(
        engine=traced_t["name"]) == 5
    assert obs_t.metrics.histogram("loop.queue_wait_s").merged()["count"] \
        == obs_j.metrics.histogram("loop.queue_wait_s").merged()["count"]
    assert obs_t.convergence.open_curves() == 0
    # protocol-neutral: tracing changes no counter and no bit
    assert traced_t["loop"] == plain_t["loop"]
    assert traced_t["engine"] == plain_t["engine"]
    for k in ("blocking_polls", "gather_launches", "host_fetch_bytes",
              "device_iters", "harvests", "refills"):
        assert traced_t["report"][k] == plain_t["report"][k], k
    for a, b in zip(traced_t["results"], plain_t["results"]):
        assert np.array_equal(a.trajectory, b.trajectory)
    assert not any(t.residual_curve for t in plain_t["tickets"])

    # tools/obs_report.py (stdlib only) reads the port's export
    path = obs_t.tracer.export(tmp_path / "trace.json")
    proc = subprocess.run([sys.executable, "tools/obs_report.py", str(path)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "stepwise.step" in proc.stdout
    assert "6 ticket span(s), 6 resolved" in proc.stdout


def test_failed_ticket_closes_span_and_discards_curve():
    def run(serving, sampling, obs_mod):
        obs = obs_mod.Observability.enabled()

        def reject(request, key):
            raise ValueError("bad request")

        key = serving.EngineKey("oracle", 8, "taa")
        queue = serving.RequestQueue(validate=reject, obs=obs)
        ticket = queue.submit(sampling.SampleRequest(label=1, seed=1), key)
        with pytest.raises(ValueError):
            ticket.result(timeout=0)
        end = [e for e in obs.tracer.events() if e["ph"] == "e"]
        return len(end), end[0]["args"]["error"], obs.metrics.counter(
            "queue.rejected").value(key=key.describe()), \
            obs.convergence.open_curves()

    got_j = run(jserving, jsampling, jobs)
    got_t = run(tserving, tsampling, tobs)
    assert got_t == got_j == (1, "bad request", 1, 0)
