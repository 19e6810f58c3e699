"""Port parity for the fault-tolerance runtime (``repro_torch.runtime``, a
copy of ``repro.runtime``): the counterparts of the reference's own tests,
each behaviour held against the JAX package's on the same inputs, and the
serving CLI's straggler deadline."""
import numpy as np
import pytest

from repro import runtime as jrt
from repro_torch import runtime as trt
from repro_torch.launch import serve as tserve


def test_heartbeat_failure_detection():
    clock = [0.0]
    mons = [m.HeartbeatMonitor(range(4), timeout_s=10, clock=lambda: clock[0])
            for m in (trt, jrt)]
    mon = mons[0]
    clock[0] = 5.0
    for w in [0, 1, 2]:
        for m in mons:
            m.beat(w, step=1)
    clock[0] = 12.0  # worker 3 silent for 12s > 10s
    assert mon.failed() == {3} == mons[1].failed()
    assert mon.alive() == {0, 1, 2}
    assert mon.quorum(0.75) and mons[1].quorum(0.75)
    clock[0] = 30.0
    assert not mon.quorum(0.75) and not mons[1].quorum(0.75)
    assert mon.last_step == mons[1].last_step


def test_restart_policy_escalation():
    p = trt.RestartPolicy(max_restarts=4, elastic_after=2)
    assert p.next_action() == "restart"
    p.record_restart(); p.record_restart()
    assert p.next_action() == "elastic"
    p.record_restart(); p.record_restart()
    assert p.next_action() == "abort"
    p.record_success_window()
    assert p.next_action() == "restart"
    j = jrt.RestartPolicy()
    t = trt.RestartPolicy()
    for _ in range(12):
        assert (t.next_action(), t.backoff()) == (j.next_action(), j.backoff())
        t.record_restart(); j.record_restart()


def test_straggler_deadline_and_duplication():
    s = trt.StragglerMitigator(window=10, deadline_factor=2.0)
    for _ in range(10):
        s.record(1.0)
    assert s.deadline() == pytest.approx(2.0)
    assert s.is_straggling(5.0) and not s.is_straggling(1.5)
    dup = s.duplicate_assignments({0: 0.9, 1: 6.0, 2: 1.1}, spare_slots=1)
    assert dup == [1]
    assert trt.StragglerMitigator().deadline() is None


def test_straggler_matches_reference_on_a_latency_stream():
    rng = np.random.default_rng(0)
    t, j = trt.StragglerMitigator(window=7), jrt.StragglerMitigator(window=7)
    for x in rng.exponential(1.0, size=40):
        t.record(float(x)); j.record(float(x))
        assert t.deadline() == j.deadline()
        lat = {i: float(v) for i, v in enumerate(rng.exponential(2.0, 5))}
        assert t.duplicate_assignments(lat, 2) == \
            j.duplicate_assignments(lat, 2)


@pytest.mark.parametrize("crash_at", [3, 7])
def test_run_supervised_restores_after_crash(crash_at):
    """A step that raises rolls back to the last checkpoint and reruns; the
    port and the reference execute the same step sequence."""
    def drive(rt):
        state = {"ckpt_step": 0, "crashed": False}
        executed = []

        def step_fn(step):
            executed.append(step)
            if step == crash_at and not state["crashed"]:
                state["crashed"] = True
                raise RuntimeError("simulated node failure")

        def save(step):
            state["ckpt_step"] = step

        final = rt.run_supervised(step_fn, start_step=0, num_steps=10,
                                  save_fn=save,
                                  restore_fn=lambda: state["ckpt_step"],
                                  policy=rt.RestartPolicy(), ckpt_every=5)
        return final, executed

    final, executed = drive(trt)
    assert final == 10
    assert executed.count(crash_at) == 2  # crashed once, re-ran after restore
    assert (final, executed) == drive(jrt)


def test_run_supervised_aborts_when_the_budget_is_spent():
    failures = []

    def always_fails(step):
        raise RuntimeError("dead node")

    with pytest.raises(RuntimeError, match="dead node"):
        trt.run_supervised(always_fails, start_step=0, num_steps=3,
                           save_fn=lambda s: None, restore_fn=lambda: 0,
                           policy=trt.RestartPolicy(max_restarts=2),
                           on_failure=lambda e, s: failures.append(s))
    assert failures == [0, 0, 0]


def test_elastic_plan_downsizes():
    p = trt.plan_elastic(256, target_model_parallel=16)
    assert p.shape == (16, 16) and p.grad_accum == 1
    p = trt.plan_elastic(128, target_model_parallel=16)
    assert p.shape == (8, 16) and p.grad_accum == 2  # batch preserved
    p = trt.plan_elastic(120, target_model_parallel=16)  # odd loss: model /= 2
    assert p.shape[0] * p.shape[1] <= 120


@pytest.mark.parametrize("multi_pod", [False, True])
def test_elastic_plan_matches_reference(multi_pod):
    for n in range(1, 300, 7):
        for mp in (1, 4, 16):
            t = trt.plan_elastic(n, target_model_parallel=mp,
                                 multi_pod=multi_pod)
            j = jrt.plan_elastic(n, target_model_parallel=mp,
                                 multi_pod=multi_pod)
            assert (t.shape, t.axis_names, t.global_batch, t.grad_accum) == \
                (j.shape, j.axis_names, j.global_batch, j.grad_accum), (n, mp)


def test_serve_prints_the_reference_deadline(monkeypatch, capsys):
    """``serve.main`` records each dispatch's wall in a StragglerMitigator
    and prints its p50 deadline; the reference's rule on the same walls
    gives the same number."""
    got = []
    real = tserve.serve_batch

    def spy(engine, requests, **kw):
        out = real(engine, requests, **kw)
        got.append((engine, out[2]))
        return out

    monkeypatch.setattr(tserve, "serve_batch", spy)
    outs, stats = tserve.main(["--smoke", "--requests", "3", "--steps-T",
                               "8", "--batch-size", "1", "--device", "cpu"])
    assert outs.shape[0] == 3 and len(stats) == 3
    [(engine, straggler)] = got
    walls = [d["wall_s"] for d in engine.last_dispatches]
    assert len(walls) == 3 and list(straggler.lat) == walls
    ref = jrt.StragglerMitigator()
    for w in walls:
        ref.record(w)
    assert straggler.deadline() == ref.deadline() is not None
    assert f"p50 deadline {ref.deadline()}" in capsys.readouterr().out
