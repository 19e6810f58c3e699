"""Port parity for the stepwise LaneBank protocol: the same scripted
open -> refill -> step -> harvest -> refill drain through the JAX engine
and the port's, over ParaTAA staged and fused, FP and sequential specs,
with mid-solve refills and mixed tau / max_iters / quality_steps / warm
starts; the protocol's rules (one blocking poll a round, retired-lane
gathers, five program kinds, fetch/adopt bit for bit), and that
``stepwise_step`` and ``stepwise_refill`` read nothing on the host."""
import numpy as np
import pytest
import torch

from repro import sampling as jsampling
from repro_torch import sampling as tsampling
from repro_torch.serving import EngineKey
from tests.test_torch_helpers import assert_same_result, label_factories
from tests.test_torch_syncs import HostReads

D = 24
T = 12
JAX_FACTORY, TORCH_FACTORY = label_factories(D)

# name -> (solver, spec overrides)
VARIANTS = {
    "taa staged": ("taa", {}),
    "taa fused": ("taa", {"fuse_round": True}),
    "fp": ("fp", {}),
    "seq": ("seq", {}),
}


def _engines(name, T=T):
    solver, spec_kw = VARIANTS[name]
    key = EngineKey("oracle", T, solver)
    return JAX_FACTORY(key, spec_kw), TORCH_FACTORY(key, spec_kw)


def _request(mod, kw):
    kw = dict(kw)
    if "init" in kw:
        traj, t_init = kw["init"]
        kw["init"] = mod.WarmStart(traj, t_init=t_init)
    return mod.SampleRequest(**kw)


def _mixed_requests(name):
    """Six requests: cold, loose tau, a warm start at depth T/2 (from a
    solve of the same label and seed), a quality-steps and a max_iters
    budget, cold (seq: six cold requests)."""
    if name == "seq":
        return [dict(label=i % 4, seed=40 + i) for i in range(6)]
    jeng, _ = _engines(name)
    [solved] = jeng.run_batch([jsampling.SampleRequest(label=1, seed=3)])
    return [dict(label=0, seed=40), dict(label=3, seed=41, tau=5e-2),
            dict(label=1, seed=3,
                 init=(np.asarray(solved.trajectory), T // 2)),
            dict(label=2, seed=43, quality_steps=2),
            dict(label=1, seed=44, max_iters=3),
            dict(label=2, seed=45)]


def drive(eng, mod, specs, *, slots=2, chunk_iters=2):
    """Open a bank, fill it, then step -> harvest -> refill the free lanes
    from the pending requests until every request retired.  Returns the
    results in request order, the final report and the rounds run."""
    reqs = [_request(mod, kw) for kw in specs]
    bank = eng.stepwise_open(slots, chunk_iters=chunk_iters)
    pending = list(range(len(reqs)))
    lane_of, out = {}, {}

    def refill():
        free = bank.free_lanes()
        take = pending[:len(free)]
        del pending[:len(take)]
        if take:
            eng.stepwise_refill(bank, free[:len(take)],
                                [reqs[i] for i in take])
            lane_of.update(zip(free, take))

    refill()
    rounds = 0
    while bank.occupied:
        eng.stepwise_step(bank)
        rounds += 1
        for lane, res in eng.stepwise_harvest(bank):
            out[lane_of.pop(lane)] = res
        refill()
        assert rounds < 200
    return [out[i] for i in range(len(reqs))], eng.stepwise_report(bank), \
        rounds


PROTOCOL_KEYS = ("blocking_polls", "gather_launches", "harvests", "refills",
                 "completed", "device_iters", "host_fetch_bytes",
                 "update_launches", "useful_iters", "device_nfe")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_stepwise_drain_matches_jax_and_run_batch(name):
    specs = _mixed_requests(name)
    jeng, teng = _engines(name)
    res_j, rep_j, rounds_j = drive(jeng, jsampling, specs)
    res_t, rep_t, rounds_t = drive(teng, tsampling, specs)
    assert rounds_t == rounds_j
    for got, want in zip(res_t, res_j):
        assert_same_result(got, want)
    for key in PROTOCOL_KEYS:
        assert rep_t[key] == rep_j[key], key
    assert rep_t["wasted_iter_frac"] == pytest.approx(
        rep_j["wasted_iter_frac"])
    # one blocking poll a round, and five program kinds
    assert rep_t["blocking_polls"] == rounds_t
    assert teng.stats["stepwise_traces"] == jeng.stats["stepwise_traces"] == 5
    for key in ("blocking_polls", "gather_launches", "host_fetch_bytes",
                "update_launches"):
        assert teng.stats[key] == jeng.stats[key], key
    if name != "seq":
        assert any(r.early_stopped for r in res_t)
    # the port's stepwise results equal its own whole-batch run
    _, fresh = _engines(name)
    ref = fresh.run_batch([_request(tsampling, kw) for kw in specs],
                          batch_size=2)
    for got, want in zip(res_t, ref):
        assert_same_result(got, want)


def test_harvest_gathers_only_retired_lanes():
    """Harvest fetches len(ready) x (T+1) x D rows, not the bank: one
    retired lane's trajectory + residual row + the (slots, 5) poll."""
    T16 = 16
    jeng, teng = _engines("taa staged", T=T16)
    fetched = []
    for eng, mod in ((jeng, jsampling), (teng, tsampling)):
        bank = eng.stepwise_open(4, chunk_iters=1)
        reqs = [mod.SampleRequest(label=0, seed=1, quality_steps=1)] + \
            [mod.SampleRequest(label=i % 4, seed=2 + i) for i in range(3)]
        eng.stepwise_refill(bank, [0, 1, 2, 3], reqs)
        eng.stepwise_step(bank)
        mark = bank.host_fetch_bytes
        [(lane, res)] = eng.stepwise_harvest(bank)
        assert lane == 0 and res.early_stopped and res.iters == 1
        fetched.append(bank.host_fetch_bytes - mark)
        assert bank.gather_launches == 1 and bank.harvests == 1
    assert fetched[0] == fetched[1] == \
        (T16 + 1) * D * 4 + T16 * 4 + 4 * 5 * 4


def test_poll_is_cached_per_round_and_invalidated():
    """One blocking poll a round, shared by harvest and report; step and
    refill invalidate it; after a refill the poll reads the state (the
    refilled lane is not finished)."""
    _, eng = _engines("taa staged")
    bank = eng.stepwise_open(2, chunk_iters=2)
    eng.stepwise_refill(bank, [0, 1], [
        tsampling.SampleRequest(label=0, seed=3, quality_steps=2),
        tsampling.SampleRequest(label=1, seed=4)])
    eng.stepwise_step(bank)
    assert bank.summary is not None and bank.poll_cache is None
    polls0 = bank.blocking_polls
    polled = eng.stepwise_poll(bank)
    assert bank.blocking_polls == polls0 + 1
    assert eng.stepwise_poll(bank) is polled
    harvested = eng.stepwise_harvest(bank)
    eng.stepwise_report(bank)
    assert bank.blocking_polls == polls0 + 1
    assert [lane for lane, _ in harvested] == [0]
    eng.stepwise_step(bank)
    assert bank.poll_cache is None
    eng.stepwise_poll(bank)
    assert bank.blocking_polls == polls0 + 2
    eng.stepwise_refill(bank, [0], [tsampling.SampleRequest(label=2, seed=5)])
    assert bank.summary is None and bank.poll_cache is None
    mark = bank.host_fetch_bytes
    polled = eng.stepwise_poll(bank)
    assert not polled["finished"][0] and polled["iters"][0] == 0
    # the fallback's fields in the reference's dtypes: bool, int32, int32,
    # bool, float32
    assert bank.host_fetch_bytes - mark == 2 * (1 + 4 + 4 + 1 + 4)
    assert polled["residual"].dtype == np.float32


def test_seq_harvest_skips_the_residual_fetch():
    _, eng = _engines("seq", T=8)
    bank = eng.stepwise_open(2, chunk_iters=8)
    eng.stepwise_refill(bank, [0, 1], [tsampling.SampleRequest(label=0, seed=7),
                                       tsampling.SampleRequest(label=1, seed=8)])
    eng.stepwise_step(bank)
    mark = bank.host_fetch_bytes
    results = eng.stepwise_harvest(bank)
    assert len(results) == 2
    assert all(res.residuals is None and res.iters == 8 for _, res in results)
    assert bank.host_fetch_bytes - mark == 2 * 9 * D * 4 + 2 * 5 * 4


def test_fetch_then_adopt_resumes_with_identical_bits():
    _, eng = _engines("taa fused")
    reqs = [tsampling.SampleRequest(label=0, seed=11),
            tsampling.SampleRequest(label=3, seed=12, tau=5e-2)]

    def finish(bank):
        out = {}
        while bank.occupied:
            eng.stepwise_step(bank)
            out.update(eng.stepwise_harvest(bank))
        return out

    bank = eng.stepwise_open(2, chunk_iters=1)
    eng.stepwise_refill(bank, [0, 1], reqs)
    eng.stepwise_step(bank)
    snap = eng.fetch_bank(bank)
    assert snap.occupied == 2 and snap.nbytes() > 0
    polls = bank.blocking_polls
    adopted = eng.adopt_bank(snap)
    assert adopted.blocking_polls == polls and adopted.device_iters == 1
    a, b = finish(bank), finish(adopted)
    assert sorted(a) == sorted(b) == [0, 1]
    for lane in a:
        assert np.array_equal(a[lane].trajectory, b[lane].trajectory)
        assert (a[lane].iters, a[lane].nfe) == (b[lane].iters, b[lane].nfe)
    assert eng.stats["stepwise_traces"] == 5


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_and_refill_read_nothing_on_the_host(name):
    """Under the dispatch mode that raises on any host read: open, a
    refill with a warm start, steps past a lane's finish and a mid-solve
    refill.  The poll, outside it, is where the host reads."""
    _, eng = _engines(name)
    bank = eng.stepwise_open(2, chunk_iters=2)
    reqs = [tsampling.SampleRequest(label=i, seed=60 + i) for i in range(3)]
    with HostReads():
        eng.stepwise_refill(bank, [0, 1], reqs[:2])
        eng.stepwise_step(bank)
        eng.stepwise_step(bank)
    done = eng.stepwise_harvest(bank)
    free = bank.free_lanes()
    with HostReads():
        if free:
            eng.stepwise_refill(bank, free[:1], reqs[2:])
        eng.stepwise_step(bank)
    assert eng.stepwise_poll(bank)["iters"].dtype == np.int32
    assert done or not free


def test_stepwise_stats_and_reset():
    """Engine stats count the protocol; reset_stats rewinds every counter
    but stepwise_traces, through the StatsView (the registry follows)."""
    _, eng = _engines("taa staged")
    _, report, rounds = drive(eng, tsampling,
                              [dict(label=i % 4, seed=80 + i)
                               for i in range(3)])
    assert eng.stats["blocking_polls"] == report["blocking_polls"] == rounds
    assert eng.stats["gather_launches"] == report["gather_launches"] > 0
    view = eng.stats
    eng.reset_stats()
    assert eng.stats is view
    assert all(v == 0 for k, v in eng.stats.items() if k != "stepwise_traces")
    assert eng.stats["stepwise_traces"] == 5
    assert eng.obs.metrics.gauge("engine.blocking_polls").value(
        engine=eng.name) == 0
    with pytest.raises(ValueError, match="chunk_iters"):
        eng.stepwise_open(2, chunk_iters=0)
    bank = eng.stepwise_open(2, chunk_iters=1)
    eng.stepwise_refill(bank, [0], [tsampling.SampleRequest(seed=1)])
    with pytest.raises(ValueError, match="not all vacant"):
        eng.stepwise_refill(bank, [0], [tsampling.SampleRequest(seed=2)])
    assert torch.equal(bank.labels, torch.zeros(2, dtype=torch.long))
