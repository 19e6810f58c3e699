"""Percentiles and the rate are taken over every request of the window."""
import random

from bench.harness.catalog import Catalog
from bench.harness.cell import Request, RunView
from bench.tests.support import ROOT


def view(latencies, seconds=10.0, iters=None):
    iters = iters or [13] * len(latencies)
    return RunView(
        cell={}, conf={}, mix={"T": 25, "slots": 1}, seconds=seconds,
        setup_s=12.5,
        requests=[Request(i, lat, it, it * 25)
                  for i, (lat, it) in enumerate(zip(latencies, iters))],
        device_kind="cpu", peaks=None, flops_per_sample_call=1.0,
        sample_size=4096, history_m=3, bank=None)


def read(name, run):
    return Catalog(ROOT).reader(name).read(run)


def test_latency_percentiles_cover_every_request():
    lat = [float(i) for i in range(1, 101)]
    random.Random(0).shuffle(lat)
    run = view(lat)
    assert read("latency_p50_s", run) == 50.5
    # the slower half decides the median, wherever it sits
    slow = [1000.0 if x > 49 else x for x in lat]
    assert read("latency_p50_s", view(slow)) == 1000.0
    slow = [1000.0 if x > 51 else x for x in lat]
    assert read("latency_p50_s", view(slow)) == 50.5


def test_rate_is_every_finished_request_over_the_window():
    run = view([0.5] * 37, seconds=20.0)
    assert read("samples_per_s", run) == 37 / 20.0
    assert read("setup_s", run) == 12.5


def test_iterations_are_the_mean_over_every_request():
    run = view([1.0] * 4, iters=[10, 11, 12, 19])
    assert read("solver.iters_per_sample", run) == 13.0


def test_trace_metrics_are_silent_without_a_trace():
    run = view([1.0] * 3)
    for name in ("taa_update_roofline", "device.mfu", "device.idle_share",
                 "denoiser.device_ms_per_iter", "serving.lane_occupancy",
                 "engine.wasted_iter_frac"):
        assert read(name, run) is None, name
