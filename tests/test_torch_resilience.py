"""``repro_torch.serving.resilience`` against ``repro.serving.resilience``.

In-process, the JAX package's one-device cases (``tests/test_resilience.py``)
on the port: the FaultInjector schedule (both packages on the same
schedules), the RestartPolicy-supervised ``_fail_bank`` funnel's backoff
sequencing against a fake clock, queue timeouts, ``stop`` never stranding a
ticket, and the straggler duplicate's determinism.

On 4 gloo ranks (``tests/test_torch_spawn.py``): the chaos drain — a debug
mesh of data 4, 2 ranks lost at round 3 — resolves every ticket, bit for
bit the drain without faults, and its resilience counters equal the JAX
package's chaos run at the same geometry (a subprocess: 4 forced host
devices, the mesh built through ``devices=``, whose axes are Auto).
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from repro.serving import FaultInjector as JFaultInjector
from repro_torch.runtime import RestartPolicy
from repro_torch.sampling import SampleRequest
from repro_torch.serving import (Batcher, BatchingPolicy, DeviceLossError,
                                 EngineKey, EngineRegistry, FaultInjector,
                                 RequestQueue, ResilientServingLoop,
                                 ServingLoop, ShutdownError,
                                 duplicate_window_eval)
from tests.test_torch_helpers import label_factories, rel_err
from tests.test_torch_placement import _run_reference, _wait, _write_inputs
from tests.test_torch_spawn import spawn

D = 16
N_LABELS = 4
T = 8
KEY = EngineKey("oracle", T, "taa")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def factory():
    return label_factories(dim=D, n_labels=N_LABELS)[1]


# --- FaultInjector ----------------------------------------------------------


@pytest.mark.parametrize("schedule,pool", [({2: 3}, 8), ({0: 99}, 2),
                                           ({1: 2, 3: 1}, 4),
                                           ({3: 2}, 4)])
def test_fault_injector_schedules_match_jax(schedule, pool):
    got, want = FaultInjector(schedule), JFaultInjector(schedule)
    devices = list(range(pool))
    for _ in range(6):
        assert got.tick(devices) == want.tick(devices)
    assert got.surviving(devices) == want.surviving(devices)
    assert got.lost == want.lost
    assert len(got.surviving(devices)) >= 1


def test_fault_injector_drops_on_schedule_from_the_tail():
    devices = list(range(8))
    inj = FaultInjector({2: 3})
    assert inj.tick(devices) == []
    assert inj.tick(devices) == []
    assert inj.tick(devices) == [5, 6, 7]       # tail drop: contiguous prefix
    assert inj.tick(devices) == []              # one-shot
    assert inj.surviving(devices) == [0, 1, 2, 3, 4]
    inj = FaultInjector({0: 99})
    assert inj.tick([0, 1]) == [1]
    inj.drop_at[1] = 5
    assert inj.tick([0, 1]) == [] and inj.surviving([0, 1]) == [0]


# --- RestartPolicy supervision of _fail_bank --------------------------------


def test_fail_bank_backoff_then_downsize_sequencing(factory):
    """Two in-place retries with exponentially backed-off sleeps (fake
    clock), then the elastic downsize; with no device pool (the host
    placement) it becomes an abort that fails every ticket."""
    clock, sleeps = FakeClock(), []
    queue = RequestQueue()
    loop = ResilientServingLoop(
        EngineRegistry(factory), queue, Batcher(BatchingPolicy(max_batch=4)),
        engine_factory=lambda key, plc: factory(key),
        policy=RestartPolicy(backoff_base_s=5.0, elastic_after=2),
        clock=clock, sleep=sleeps.append, chunk_iters=2)
    tickets = [queue.submit(SampleRequest(label=i % N_LABELS, seed=20 + i),
                            KEY) for i in range(4)]
    loop.pump(flush=True)
    assert loop._banks[KEY].occupied == 4
    loop._fail_bank(KEY, RuntimeError("injected device fault"))
    assert sleeps == [10.0] and KEY in loop._banks
    loop._fail_bank(KEY, RuntimeError("injected device fault"))
    assert sleeps == [10.0, 20.0]
    assert loop.resilience["retries"] == 2
    loop._fail_bank(KEY, RuntimeError("injected device fault"))
    assert sleeps == [10.0, 20.0, 40.0]
    assert isinstance(loop.error, DeviceLossError)
    assert loop.resilience["rebuilds"] == 0
    for t in tickets:
        assert t.done()
        with pytest.raises(DeviceLossError):
            t.result(timeout=0)


def test_unrecoverable_error_fails_bank_immediately(factory):
    queue, sleeps = RequestQueue(), []
    loop = ResilientServingLoop(
        EngineRegistry(factory), queue, Batcher(BatchingPolicy(max_batch=4)),
        engine_factory=lambda key, plc: factory(key), sleep=sleeps.append,
        chunk_iters=2)
    ticket = queue.submit(SampleRequest(label=0, seed=30), KEY)
    loop.pump(flush=True)
    loop._fail_bank(KEY, ValueError("bad request shape"))
    assert sleeps == [] and loop.resilience["retries"] == 0
    with pytest.raises(ValueError):
        ticket.result(timeout=0)
    assert loop.error is None
    with pytest.raises(ValueError, match="chunk_iters > 0"):
        ResilientServingLoop(EngineRegistry(factory), RequestQueue(),
                             engine_factory=lambda key, plc: factory(key))


# --- per-ticket timeouts ----------------------------------------------------


def test_queue_and_loop_timeouts(factory):
    clock = FakeClock()
    queue = RequestQueue(clock=clock)
    t_short = queue.submit(SampleRequest(label=0, seed=1, timeout_s=5.0), KEY)
    t_long = queue.submit(SampleRequest(label=1, seed=2, timeout_s=50.0), KEY)
    queue.submit(SampleRequest(label=2, seed=3), KEY)
    assert queue.sweep_expired() == []
    clock.t = 10.0
    assert queue.sweep_expired() == [t_short] and not t_short.done()
    clock.t = 100.0
    assert queue.sweep_expired() == [t_long] and len(queue) == 1

    clock = FakeClock()
    queue = RequestQueue(clock=clock)
    loop = ServingLoop(EngineRegistry(factory), queue,
                       Batcher(BatchingPolicy(max_batch=4)), chunk_iters=2)
    expired = queue.submit(SampleRequest(label=0, seed=40, timeout_s=5.0),
                           KEY)
    kept = queue.submit(SampleRequest(label=1, seed=41, timeout_s=500.0), KEY)
    clock.t = 10.0
    loop.drain()
    with pytest.raises(TimeoutError, match="expired in queue"):
        expired.result(timeout=0)
    assert kept.result(timeout=0).iters
    assert (loop.stats["failed"], loop.stats["completed"]) == (1, 1)

    # an admitted ticket runs to completion past its deadline
    clock = FakeClock()
    queue = RequestQueue(clock=clock)
    loop = ServingLoop(EngineRegistry(factory), queue,
                       Batcher(BatchingPolicy(max_batch=4)), chunk_iters=2)
    ticket = queue.submit(SampleRequest(label=0, seed=42, timeout_s=5.0),
                          KEY)
    loop.pump(flush=True)
    clock.t = 10.0
    loop.drain()
    assert ticket.result(timeout=0) is not None


# --- stop() never strands a ticket ------------------------------------------


def test_stop_without_drain_fails_open_tickets(factory):
    queue = RequestQueue()
    loop = ServingLoop(EngineRegistry(factory), queue,
                       Batcher(BatchingPolicy(max_batch=4)))
    loop.start(poll_s=0.001)
    loop._stop_event.set()                      # park the worker first
    loop._thread.join()
    stranded = queue.submit(SampleRequest(label=0, seed=50), KEY)
    two_tier = queue.submit(SampleRequest(label=1, seed=51), KEY)
    draft = object()
    two_tier.resolve_draft(draft)
    loop.stop(drain=False)
    for t in (stranded, two_tier):
        with pytest.raises(ShutdownError):
            t.result(timeout=0)
    assert two_tier.draft_result(timeout=0) is draft
    late = queue.submit(SampleRequest(label=2, seed=52), KEY)
    with pytest.raises(ShutdownError):
        late.result(timeout=0)


def test_stop_with_drain_resolves_everything(factory):
    queue = RequestQueue()
    loop = ServingLoop(EngineRegistry(factory), queue,
                       Batcher(BatchingPolicy(max_batch=4)), chunk_iters=2)
    loop.start(poll_s=0.001)
    tickets = [queue.submit(SampleRequest(label=i % N_LABELS, seed=60 + i),
                            KEY) for i in range(6)]
    time.sleep(0.01)
    loop.stop()
    assert all(t.result(timeout=0) is not None for t in tickets)
    assert loop.error is None


# --- straggler duplication ---------------------------------------------------


def test_duplicate_window_eval_is_deterministic_in_value(factory):
    queue = RequestQueue()
    loop = ServingLoop(EngineRegistry(factory), queue,
                       Batcher(BatchingPolicy(max_batch=4)), chunk_iters=2)
    for i in range(4):
        queue.submit(SampleRequest(label=i % N_LABELS, seed=70 + i), KEY)
    loop.pump(flush=True)
    loop.pump(flush=True)
    engine, bank = loop.registry.get(KEY), loop._banks[KEY]
    primary, winner0 = duplicate_window_eval(engine, bank, 0)
    assert winner0 == "primary" and primary.shape == (bank.slots,)
    dup, winner = duplicate_window_eval(engine, bank, 0,
                                        device=torch.device("cpu"))
    assert winner in ("primary", "spare")
    assert np.array_equal(primary, dup)
    loop.drain()


# --- the chaos drain on 4 gloo ranks ------------------------------------------

CHAOS_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "tests")
import json
import jax
import numpy as np
from helpers import make_label_denoiser
from repro.core import ddim_coeffs
from repro.launch.mesh import make_mesh
from repro.sampling import Placement, SampleRequest, SamplingEngine, get_sampler
from repro.serving import (Batcher, BatchingPolicy, EngineKey, EngineRegistry,
                           FaultInjector, RequestQueue, ResilientServingLoop)

D, T = 16, 8
out_path, drop, rnd = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
eps_apply = make_label_denoiser(dim=D, n_labels=4)
key = EngineKey("oracle", T, "taa")

def factory(k, plc):
    return SamplingEngine(eps_apply, None, ddim_coeffs(k.T),
                          get_sampler(k.solver), sample_shape=(D,),
                          placement=plc)

# devices=: a plain Mesh with Auto axes (jax.make_mesh's Explicit axes are
# refused by with_sharding_constraint)
plc = Placement.for_mesh(make_mesh("debug", data_parallel=4,
                                   model_parallel=1, devices=jax.devices()))
reqs = [SampleRequest(label=i % 4, seed=100 + i,
                      **({} if i % 3 == 0
                         else dict(tau=1e-2, quality_steps=1 + i % 4)))
        for i in range(10)]
registry = EngineRegistry(lambda k: factory(k, plc))
queue = RequestQueue()
loop = ResilientServingLoop(
    registry, queue, Batcher(BatchingPolicy(max_batch=4)),
    engine_factory=factory, placement=plc,
    injector=FaultInjector({rnd: drop}), chunk_iters=2)
tickets = [queue.submit(r, key) for r in reqs]
loop.drain()
res = [t.result(timeout=0) for t in tickets]
np.savez(out_path, x0=np.stack([np.asarray(r.x0) for r in res]))
print("RESULT " + json.dumps({
    "resilience": {k: v for k, v in loop.resilience.items()},
    "iters": [r.iters for r in res], "nfe": [r.nfe for r in res],
    "devices_after": registry.get(key).placement.num_devices}))
"""

COUNTERS = ("device_losses", "rebuilds", "recovered_lanes", "recovery_nfe",
            "resubmitted_lanes", "draft_fallbacks", "retries")


def test_chaos_drain_on_gloo_matches_jax_counters(tmp_path):
    drop, rnd = 2, 3
    ref_proc = _run_reference(CHAOS_REF, tmp_path / "ref.npz", drop, rnd)
    _write_inputs(tmp_path / "inputs.npz", range(100, 110), steps=T,
                  drop=drop, round=rnd)
    outs = spawn("chaos", 4, tmp_path)
    lead = outs[0]
    assert lead["resolved"] == [10, 10], lead
    assert lead["bitwise"], "resumed solves diverged from the drain " \
        "without faults"
    assert lead["devices_after"] == 2
    assert lead["placement_after"].startswith("mesh[data=2 x model=1]")
    # the survivors serve on; the lost ranks only follow headers
    assert [o["serving"] for o in outs] == [True, True, False, False]
    line = [ln for ln in _wait(ref_proc).splitlines()
            if ln.startswith("RESULT ")][0]
    ref = json.loads(line[7:])
    assert ref["devices_after"] == lead["devices_after"]
    for name in COUNTERS:
        assert lead["resilience"][name] == ref["resilience"][name], name
    assert lead["resilience"]["recovered_lanes"] >= 1
    assert lead["resilience"]["rebuild_wall_s"] > 0
    assert (lead["iters"], lead["nfe"]) == (ref["iters"], ref["nfe"])
    port_x0 = np.load(tmp_path / "port.npz")["x0"]
    ref_x0 = np.load(tmp_path / "ref.npz")["x0"]
    assert rel_err(port_x0, ref_x0) < 1e-4
