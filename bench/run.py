"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells).  With
``--trace 0`` it reports the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics from a profiled window.  Every run checks the
served requests against the plain reference; the numbers compared, each
with its limit, are the last lines on standard error and the result's
last key.  The last line on standard output is the result, one JSON
object.  Exits non-zero, printing no result, without a CUDA card, or when
JAX, the JAX package or its benchmarks are loaded once the window closed.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def environment(root: Path) -> None:
    """Caches inside the checkout, at fixed paths (the program's own
    kernel build goes to ``build/kernels``); the program from its
    ``src``."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for path in (str(root / "src"), str(root)):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    args = parse(argv)
    environment(ROOT)
    import torch

    from bench.harness.catalog import Catalog
    from bench.harness.cell import forbidden_modules, run_cell

    cat = Catalog(ROOT)
    chips = int(cat.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"no result: the cell needs {chips} CUDA device(s), "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             f" found")
        return 2
    out = run_cell(cat, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T0, _log)
    bad = forbidden_modules()
    if bad:
        _log(f"no result: loaded after the window: {', '.join(bad)}")
        return 3
    _log(f"correct {out['correct']}")
    for key, c in out["checks"].items():
        _log(f"check {key} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
