"""Nothing the benchmark runs loads JAX, the JAX package or its
benchmarks, judged by each module's top-level name as a whole, and the
plain references load nothing of the program."""
import json
import subprocess
import sys

from bench.harness.cell import forbidden_modules
from bench.tests.support import ROOT

HARNESS = ["bench.run", "bench.control", "bench.harness.catalog",
           "bench.harness.cell", "bench.harness.check",
           "bench.harness.serve", "bench.harness.trace",
           "bench.harness.traffic", "bench.harness.weights",
           "bench.harness.roofline"]
REFERENCE = ["bench.reference.shared", "bench.reference.ddim",
             "bench.reference.dit", "bench.reference.mamba2"]


def loaded_after(modules, extra=""):
    code = ("import importlib, json, sys\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            f"sys.argv = ['x']\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"{extra}\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_and_readers_load_no_jax():
    extra = ("from bench.harness.catalog import Catalog\n"
             "cat = Catalog(sys.path[0])\n"
             "for w in cat.spec['workloads']:\n"
             "    c = cat.cell(w['name']); f = cat.config(c['config'])\n"
             "    [cat.module(k, f['family']) for k in "
             "('denoisers', 'reference', 'flops')]\n"
             "    mix = cat.traffic(c['traffic'])\n"
             "    cat.module('arrivals', mix['arrival'])\n"
             "    [cat.reader(m['name']) for t in (0, 1) "
             "for m in cat.metrics(w['name'], t)]\n"
             "import repro_torch.serving, repro_torch.diffusion.dit\n"
             "import repro_torch.kernels.ops, repro_torch.models.backbone")
    top = loaded_after(HARNESS, extra)
    assert not top & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert "repro_torch" in top


def test_references_load_nothing_of_the_program():
    top = loaded_after(REFERENCE)
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_whole_top_level_names():
    assert forbidden_modules(["repro_torch", "repro_torch.serving",
                              "jaxtyping", "benchmarks_x", "bench"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "flax",
                              "benchmarks.run", "jaxlib"]) == [
        "benchmarks", "flax", "jax", "jaxlib", "repro"]
