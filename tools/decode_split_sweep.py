#!/usr/bin/env python3
"""Device time of the split-KV flash decode's two passes against the size
of its key ranges, on one NVIDIA GPU.

    python3 tools/decode_split_sweep.py [--chunks 16,48,128,512,1024]

Takes the decode cases of ``chip_smoke.py``'s phase 4 (qwen3-0.6b with a
bf16 and an int8 cache, recurrentgemma-2b MQA; inputs from the same numpy
seed), forces each range size in place of ``flash_decode.split_plan``'s
choice, checks the output against its plain version, and prints the split
pass's and the combine pass's device time per call (torch.profiler, summed
by kernel name).  For split_plan's own choice it also prints, per call, the
host time to enqueue (perf_counter over back-to-back calls, no sync) and
the wall time (CUDA events over the same calls).  A yardstick: one PyTorch
reduction over a bf16 tensor of the qwen3 cache's shape.  Needs CUDA; fails
without it.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def device_us_by_kernel(fn, reps: int = 20) -> dict:
    """Device microseconds per call, summed by kernel: "split", "combine",
    or the first 30 characters of any other kernel's name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = "combine" if "combine_kernel" in e.name else \
                "split" if "split_kernel" in e.name else e.name[:30]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / reps
    return out


def host_and_wall_us(fn, calls: int = 200):
    """(host enqueue us, wall us) per call over ``calls`` back-to-back
    calls after a warm-up."""
    import time

    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    stop.record()
    stop.synchronize()
    return host, start.elapsed_time(stop) / calls * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="16,48,128,512,1024",
                    help="range sizes in keys, comma-separated")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("decode_split_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import flash_decode

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    chunks = [int(c) for c in args.chunks.split(",")]
    plan = flash_decode.split_plan
    cases = [c for c in chip_smoke.model_cases()
             if c["kernel"] == "flash_decode"]
    try:
        for case in cases:
            T = 4096 if "T=4096" in case["label"] else 2048
            flash_decode.split_plan = plan
            host, wall = host_and_wall_us(case["run"])
            print(f"{case['label']}: split_plan {case['path']}; per call "
                  f"host {host} us, wall {wall} us, device "
                  f"{device_us_by_kernel(case['run'])}")
            for chunk in chunks:
                if chunk >= T:
                    continue
                splits = -(-T // chunk)
                flash_decode.split_plan = \
                    lambda *a, s=splits, c=chunk: (s, c)
                err = float((case["run"]().float()
                             - case["plain"]().float()).abs().max())
                us = device_us_by_kernel(case["run"])
                print(f"  {chunk} keys x {splits} splits: device us "
                      f"{us}, max abs err {err}")
    finally:
        flash_decode.split_plan = plan
    cache = torch.randn(8, 4096, 8, 128, device="cuda", dtype=torch.bfloat16)
    print(f"yardstick: sum of a (8, 4096, 8, 128) bf16 tensor (67,108,864 "
          f"B): device us {device_us_by_kernel(lambda: cache.sum(dtype=torch.float32))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
