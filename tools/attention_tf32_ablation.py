#!/usr/bin/env python3
"""Where the TF32 attention kernel's time goes on the card: phases of
``src/repro_torch/kernels/csrc/flash_attention.cu`` taken out in turn, and
its design choices turned back one at a time.

    python3 tools/attention_tf32_ablation.py

Builds the source as it is and one copy per entry below (the copy's text
with the change made, written under ``build/attention_ablation/``), runs
each at DiT-XL's attention shape (B=50 = 2 lanes x 25-row window, H=16,
S=T=256, D=72, float32, non-causal; inputs from numpy seed 4 as in
chip_smoke.py phase 4) and prints its device time per call from
torch.profiler, with SDPA's beside it.  A copy with a phase taken out
computes a wrong result and only its time is read; a design variant must
still agree with the plain version (3e-5), and its error is printed.
Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (name, is a design variant (else a phase taken out), [(text, replacement)])
ENTRIES = [
    ("variant: one 16-row m-tile a warp (64 queries a CTA)", True,
     [("  return NJ <= 9 ? 2 : 1;\n}", "  return 1;\n}")]),
    ("variant: 64-key tiles up to D = 128", True,
     [("  return 32;\n}", "  return NJ <= 16 ? 64 : 32;\n}")]),
    ("variant: mma asm not volatile (the compiler may reorder products)",
     True, [("  asm volatile(\n      \"mma.sync", "  asm(\n      \"mma.sync")]),
    ("variant: staging loops unrolled", True,
     [("kThreads - 1) / kThreads;\n#pragma unroll 1\n",
       "kThreads - 1) / kThreads;\n#pragma unroll\n")]),
    ("no Q K^T product", False,
     [("        for (int mt = 0; mt < MT; ++mt) mma3(s[mt][n], a[mt], b);\n",
       "")]),
    ("no P V product", False,
     [("          for (int mt = 0; mt < MT; ++mt) mma3(o[mt][j], a[mt], b);\n",
       "")]),
    ("no exp2 in the softmax", False,
     [("const float p = exp2_approx(s[mt][n][e] - m[mt][e >> 1]);",
       "const float p = s[mt][n][e] - m[mt][e >> 1];")]),
]


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


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("attention_tf32_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    source = fa.SOURCE.read_text()
    out_dir = ROOT / "build" / "attention_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = [("unchanged", True, fa.SOURCE)]
    for i, (name, variant, edits) in enumerate(ENTRIES):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name!r}: {old!r} is not in the source "
                                   f"once")
            text = text.replace(old, new)
        path = out_dir / f"flash_attention_ablation{i}.cu"
        path.write_text(text)
        runs.append((name, variant, path))
    runs.append(("unchanged, again", True, fa.SOURCE))
    build.build_all(tuple(path for _, _, path in runs))  # nvcc in parallel
    rng = np.random.default_rng(4)
    B, H, S, T, D = 50, 16, 256, 256, 72
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, H, n, D), dtype=np.float32)).cuda() for n in (S, T, T))
    want = ref.attention_ref(q, k, v, causal=False)
    print(f"SDPA: device ms per call "
          f"{device_ms(lambda: F.scaled_dot_product_attention(q, k, v))}")
    original = fa.SOURCE
    try:
        for name, variant, path in runs:
            fa.SOURCE = path
            fa._lib.cache_clear()
            run = lambda: fa.flash_attention(q, k, v, causal=False)  # noqa
            err = float((run() - want).abs().max()) if variant else None
            print(f"{name}: device ms per call {device_ms(run)}"
                  + (f", max abs err {err}" if variant else ""), flush=True)
    finally:
        fa.SOURCE = original
        fa._lib.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
