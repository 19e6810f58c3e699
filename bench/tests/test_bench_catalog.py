"""The harness finds configurations, cells, traffic and metric readers by
name, and picks up new ones added as files only."""
import json

import torch

from bench.harness.catalog import Catalog
from bench.harness.cell import run_cell
from bench.tests.support import ROOT, copy_bench


def test_every_name_in_the_benchmark_resolves():
    cat = Catalog(ROOT)
    for entry in cat.spec["workloads"]:
        cell = cat.cell(entry["name"])
        conf = cat.config(cell["config"])
        assert conf["name"] == cell["config"]
        cat.traffic(cell["traffic"])
        for kind in ("denoisers", "reference", "flops"):
            cat.module(kind, conf["family"])
        assert set(cell["check"]["limits"])
        for trace in (False, True):
            for metric in cat.metrics(entry["name"], trace):
                assert callable(cat.reader(metric["name"]).read)
    for conf in cat.spec["configs"]:
        assert (ROOT / conf["file"]).exists()


def test_each_cell_reports_its_own_metrics():
    cat = Catalog(ROOT)
    e2e = {w["name"]: {m["name"] for m in cat.metrics(w["name"], False)}
           for w in cat.spec["workloads"]}
    assert e2e["dit-xl-2-256.taa25.c8"] == {
        "latency_p50_s", "samples_per_s", "setup_s"}
    assert e2e["mamba2-1.3b-denoiser.taa25.c1"] == {"latency_p50_s",
                                                   "setup_s"}
    assert e2e["dit-xl-2-256.taa25.c1"] == {"latency_p50_s", "setup_s"}
    layers = {m["name"] for m in cat.metrics("dit-xl-2-256.taa25.c1", True)}
    assert "serving.lane_occupancy" not in layers
    assert {"solver.iters_per_sample", "device.mfu"} <= layers


def test_new_configuration_cell_and_metric_need_only_new_files(tmp_path):
    root = copy_bench(tmp_path)
    bench = root / "bench"
    conf = json.loads((bench / "configs" / "dit-xl-2-256.json").read_text())
    conf.update(name="dit-small", depth=1, hidden_size=32, num_heads=2,
                input_size=4)
    (bench / "configs" / "dit-small.json").write_text(json.dumps(conf))
    # an arrival process of its own: one request every 0.4 s, none after
    (bench / "arrivals" / "every_0.4s.py").write_text(
        "class Arrivals:\n"
        "    def __init__(self, mix, seed):\n"
        "        pass\n"
        "    def first(self, horizon_s):\n"
        "        return [(0.4 * i, i) for i in range(int(horizon_s / 0.4))]\n"
        "    def after(self, client, at_s):\n"
        "        return None\n")
    mix = json.loads((bench / "traffic" / "taa25.c1.json").read_text())
    mix.update(T=6, clients=2, slots=2, arrival="every_0.4s")
    (bench / "traffic" / "taa6.c2.json").write_text(json.dumps(mix))
    cell = "dit-small.taa6.c2"
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps({
        "check": {"sample": 2, "block": 2, "limits": {"x0_err": 1e-2}}}))
    (bench / "metrics" / "solver.nfe_per_sample.py").write_text(
        "def read(run):\n"
        "    return sum(r.nfe for r in run.requests) / len(run.requests)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dit-small", "source": "x",
                            "file": "bench/configs/dit-small.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": cell, "config": "dit-small",
                              "traffic": "taa6.c2", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "solver.nfe_per_sample",
                              "unit": "evals", "better": "lower",
                              "source": "program_counter", "layer": "solver",
                              "moves": "latency_p50_s",
                              "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cat = Catalog(root)
    assert "solver.nfe_per_sample" in {
        m["name"] for m in cat.metrics(cell, True)}
    out = run_cell(cat, cell, 5, 3.0, True, torch.device("cpu"), 0.0,
                   lambda _: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 7        # 0, 0.4, ..., 2.4 s
    # a window of T = 6 evaluations an iteration, more than one iteration
    nfe = out["metrics"]["solver.nfe_per_sample"]["value"]
    assert nfe > 6
    # a metric listed for other cells stays out of this one's line
    assert "solver.iters_per_sample" not in out["metrics"]
