"""The precision control at a size a test can hold: the reference in
bfloat16 put in the program's place reads far above a sound run of the
program on the same cell, requests and seed."""
import json
import os
import subprocess
import sys

import pytest
import torch

from bench.harness.catalog import Catalog
from bench.harness.cell import run_cell
from bench.tests.support import ROOT

SEED = 2 ** 31 + 5


@pytest.mark.parametrize("cell", ["dit-xl-2-256.taa25.c1",
                                  "mamba2-1.3b-denoiser.taa25.c1"])
def test_control_reads_far_above_the_program(tiny_root, cell):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "bench/control.py", "--workload", cell, "--seeds",
         str(SEED), "--device", "cpu"], cwd=tiny_root, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    control = json.loads(out.stdout.splitlines()[-1])["bf16"]["numbers"]
    program = run_cell(Catalog(tiny_root), cell, SEED, 5.0, False,
                       torch.device("cpu"), 0.0, lambda _: None)
    for name, check in program["checks"].items():
        assert control[name] > 3 * check["value"], (name, control, check)
