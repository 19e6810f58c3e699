#!/usr/bin/env python3
"""Where the SSD scan's time goes on the card: each phase of the two
kernels of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` taken out in turn.

    python3 tools/ssd_scan_ablation.py

Builds the source as it is and one copy per ablation (the copy's text with
one phase removed, written under ``build/ssd_ablation/``), runs each at
mamba2-1.3b's widths (b=2, s=2048, h=64, p=64, n=128, float32, inputs from
numpy seed 4 as in chip_smoke.py phase 4) and prints each kernel's device
time per call from torch.profiler.  A copy with a phase removed computes a
wrong result; only its time is read.  The gap to the unchanged source is
what the phase costs where nothing else hides it.  Needs a CUDA device.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (name, text in the source, what replaces it)
ABLATIONS = [
    ("chunk: no local-state product",
     "          mma3(acc[q], a, fb);\n        }\n      }\n"
     "      float* st = states",
     "        }\n      }\n      float* st = states"),
    ("chunk: no intra-chunk W x product",
     "      for (int k0 = 0; k0 < (mt + 1) * 16; k0 += 8) {",
     "      for (int k0 = 0; k0 < 0; k0 += 8) {"),
    ("chunk: no C B^T product",
     "    for (int k0 = 0; k0 < N; k0 += 8) {\n      FragA a;\n"
     "      const float* cr = cs",
     "    for (int k0 = 0; k0 < 0; k0 += 8) {\n      FragA a;\n"
     "      const float* cr = cs"),
    ("pass: no inter-chunk product or y write",
     "    if (c > 0) {  // chunk 0 enters with state 0",
     "    if (c < 0) {"),
]


def device_ms(fn, reps: int = 10) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            key = "chunk_kernel" if "chunk_kernel" in ev.name else \
                "pass_kernel" if "pass_kernel" in ev.name else ev.name
            out[key] = out.get(key, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    return out


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    if not torch.cuda.is_available():
        print("ssd_scan_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rng = np.random.default_rng(4)

    def t(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).cuda()

    b, s, h, p, n = 2, 2048, 64, 64, 128
    x = t(b, s, h, p, scale=0.5)
    dt = torch.nn.functional.softplus(t(b, s, h))
    A = -torch.exp(t(h, scale=0.3))
    B, C = t(b, s, n, scale=0.5), t(b, s, n, scale=0.5)
    source = ssd.SOURCE.read_text()
    out_dir = ROOT / "build" / "ssd_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = [("unchanged", ssd.SOURCE)]
    for i, (name, old, new) in enumerate(ABLATIONS):
        if source.count(old) != 1:
            raise RuntimeError(f"ablation {name!r}: its text is not in the "
                               f"source once")
        path = out_dir / f"ssd_scan_ablation{i}.cu"
        path.write_text(source.replace(old, new))
        runs.append((name, path))
    original = ssd.SOURCE
    try:
        for name, path in runs:
            ssd.SOURCE = path
            ssd._lib.cache_clear()
            ms = device_ms(lambda: ssd.ssd_scan(x, dt, A, B, C))
            print(f"{name}: device ms per call {ms} (sum {sum(ms.values())})",
                  flush=True)
    finally:
        ssd.SOURCE = original
        ssd._lib.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
