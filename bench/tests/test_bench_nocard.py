"""A run that finds no card fails, printing no result, as does one that
finds JAX loaded once its window closed, and a checkout holding only the
benchmark's files cannot run."""
import os
import subprocess
import sys

import torch

from bench import run as bench_run
from bench.harness import cell
from bench.tests.support import ROOT, copy_bench


def run(cmd, cwd, env=None):
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run([sys.executable, "bench/run.py", "--workload",
               "dit-xl-2-256.taa25.c1", "--seed", "2147483659",
               "--seconds", "1", "--trace", "0"], ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    root = copy_bench(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, torch; sys.path.insert(0, '.');"
            "from bench.harness.catalog import Catalog;"
            "from bench.harness.cell import run_cell;"
            "print(run_cell(Catalog('.'), 'dit-xl-2-256.taa25.c1', 1, 1.0,"
            " False, torch.device('cpu'), 0.0, print))")
    out = run([sys.executable, "-c", code], root, env)
    assert out.returncode != 0
    assert "repro_torch" in out.stderr


def test_jax_loaded_after_the_window_no_result(monkeypatch, capsys):
    monkeypatch.setattr(bench_run, "environment", lambda root: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cell, "run_cell",
                        lambda *a, **k: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "jax.fake_for_test", sys)
    code = bench_run.main(["--workload", "dit-xl-2-256.taa25.c1", "--seed",
                           "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0
    assert out.out == ""
    assert "jax" in out.err
