#!/usr/bin/env python3
"""Where the RG-LRU scan's time goes on the card: phases of
``src/repro_torch/kernels/csrc/rglru_scan.cu`` taken out in turn.

    python3 tools/rglru_scan_ablation.py [--source PATH]

Builds the source as it is and one copy per ablation (the copy's text with
one phase removed, written under ``build/rglru_ablation/``), runs each at
recurrentgemma-2b's widths (B=2, S=4096, C=2560; float32 and bfloat16,
inputs from numpy seed 4 as in chip_smoke.py phase 4) and prints its device
time per call from torch.profiler.  A copy with a phase removed computes a
wrong result; only its time is read.

Two designs are known, told apart by their text:

* the chained one-read scan (the committed source): without the wait on
  the previous tile's state, and with loads, maps, scan and chain but no
  second run over the registers and no store of h;
* the two-pass chunk scan that it replaced (pass the older source with
  ``--source``, for example from ``git show <commit>:src/repro_torch/
  kernels/csrc/rglru_scan.cu``): pass 1 alone, without pass 2's second read
  of a and b and its store of h.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# design: (marker in its source, [(name, text in the source, replacement)])
DESIGNS = {
    "chained": ("// 3. the chain: wait for the previous segment's state", [
        ("no wait on the previous tile",
         "            } while ((x >> 32) != want);",
         "            } while (false);"),
        ("loads, maps, scan and chain only (no second run, no store of h)",
         "    // 4. carry in, then the 8 steps again from registers, writing h\n"
         "    if (cols) {",
         "    // 4. carry in, then the 8 steps again from registers, writing h\n"
         "    if (cols && S < 0) {"),
    ]),
    "two-pass": ("// pass 2: the recurrence again from the carry, writing h", [
        ("pass 1 alone (no second read of a and b, no store of h)",
         "  for (int t = t0; t < t1; ++t) {\n    const size_t i = base",
         "  for (int t = t0; t < t0; ++t) {\n    const size_t i = base"),
    ]),
}


def device_ms(fn, reps: int = 20, warm_s: float = 0.5) -> float:
    """Device time per call from torch.profiler, after ``warm_s`` seconds
    of calls (the card's clocks rise under load)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    while time.monotonic() - t0 < warm_s:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def runner(design: str, path: Path, a, b):
    """A call of the library built from ``path`` on (a, b)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as rg

    if design == "chained":
        original = rg.SOURCE
        rg.SOURCE = path
        rg._lib.cache_clear()
        try:
            lib = rg._lib()
        finally:
            rg.SOURCE = original
            rg._lib.cache_clear()
        return lambda: _chained(lib, rg, a, b)
    lib = build.load(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [P, P, P, I, I, I, I, I, P]
    h = torch.empty_like(a)
    B, S, C = a.shape
    dtype = 0 if a.dtype == torch.float32 else 1
    return lambda: lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, C, dtype, 0,
        build.stream_of(a))


def _chained(lib, rg, a, b):
    import torch

    B, S, C = a.shape
    plan = rg.tile_plan(B, S, C, a.element_size())
    words, tag = rg._chain_words(a, B * C, plan["segments"] + 1)
    h = torch.empty_like(a)
    info = (ctypes.c_int * 3)()
    err = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                words.data_ptr(), tag, info, B, S, C,
                                0 if a.dtype == torch.float32 else 1, 0,
                                rg._build.stream_of(a))
    rg._build.raise_on(err, "rglru_scan (ablation)")


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as rg

    parser = argparse.ArgumentParser()
    parser.add_argument("--source", type=Path, default=rg.SOURCE)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("rglru_scan_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    source = args.source.read_text()
    design = next((d for d, (marker, _) in DESIGNS.items()
                   if marker in source), None)
    if design is None:
        raise RuntimeError(f"{args.source}: not a design this tool knows")
    out_dir = ROOT / "build" / "rglru_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "".join(ch for ch in design if ch.isalnum())
    runs = [("unchanged", out_dir / f"rglru_scan_{tag}.cu")]
    runs[0][1].write_text(source)
    for i, (name, old, new) in enumerate(DESIGNS[design][1]):
        if source.count(old) != 1:
            raise RuntimeError(f"ablation {name!r}: its text is not in the "
                               f"source once")
        path = out_dir / f"rglru_scan_{tag}_ablation{i}.cu"
        path.write_text(source.replace(old, new))
        runs.append((name, path))
    build.build_all(tuple(path for _, path in runs))  # nvcc in parallel
    rng = np.random.default_rng(4)
    B, S, C = 2, 4096, 2560
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.sigmoid(torch.from_numpy(rng.standard_normal(
            (B, S, C), dtype=np.float32)).cuda()).to(dtype)
        b = (torch.from_numpy(rng.standard_normal(
            (B, S, C), dtype=np.float32)).cuda() * 0.3).to(dtype)
        for name, path in runs:
            ms = device_ms(runner(design, path, a, b))
            print(f"{design} {str(dtype).split('.')[-1]} B={B} S={S} C={C} "
                  f"{name}: device ms per call {ms}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
