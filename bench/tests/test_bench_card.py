"""One short run of every cell on the card, as the driver makes it: the
result line's keys, the device, and ``correct``.  Skips without a card."""
import json
import subprocess
import sys

import pytest

from bench.harness.catalog import Catalog
from bench.tests.support import ROOT

CELLS = [w["name"] for w in Catalog(ROOT).spec["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cuda_device, cell, trace):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "8", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = {m["name"] for m in Catalog(ROOT).metrics(cell, bool(trace))}
    assert set(line["metrics"]) <= want
    if trace:
        assert line["device"]["busy_s"] > 0
    else:
        assert set(line["metrics"]) == want
