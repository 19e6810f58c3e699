#!/usr/bin/env python3
"""Where K1 ``taa_gram``'s time goes on the card: parts of
``src/repro_torch/kernels/csrc/taa_update.cu``'s Gram kernel taken out in
turn.

    python3 tools/taa_gram_ablation.py [--source PATH] [--source PATH ...]

Builds each source as it is and one copy per ablation (the copy's text
with one part removed, written under ``build/gram_ablation/``), runs each
at the main path's shape (chip_smoke.py phase 2's timed case: B=2, m=3,
T=25, D=4096, float32, every row in the window, inputs from numpy seed 1)
and prints its device time per call from torch.profiler.  A copy with a
part removed computes a wrong result; only its time is read.

Two designs are known, told apart by their text:

* the tiled kernel (a row's 512-element tiles in one thread block
  cluster, their sums gathered in the first CTA's shared memory): without
  the row's reduction (every CTA writes its own tile's sums and stops: no
  store to another CTA, no cluster barrier, no sum over the tiles),
  without the loads (every tile treated as masked after its row's weight
  is read, so no stream is read), and without both;
* the one-CTA-per-row kernel it replaced (pass the older source, for
  example from ``git show <commit>:src/repro_torch/kernels/csrc/
  taa_update.cu``): as it is.

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

NO_REDUCTION = [
    ("  float* root = cluster.map_shared_rank(sums, 0);",
     "  float* root = sums;"),
    ("  cluster.sync();  // every tile's sums are in the first CTA's shared "
     "memory\n  if (rank != 0) return;",
     "  write_gram<M>(total, g, ur);\n  return;")]
NO_LOADS = [
    ("    load_tile<T, M, VEC>(dF, R, w, b, t, j, Tn, D, whole, f, r);",
     "    load_tile<T, M, VEC>(dF, R, 0.f, b, t, j, Tn, D, whole, f, r);")]
# design: (marker in its source, [(name, [(text, replacement), ...])])
DESIGNS = {
    "tiled": ("cluster.map_shared_rank(sums, 0)", [
        ("without the row's reduction", NO_REDUCTION),
        ("without the loads", NO_LOADS),
        ("without the loads and the row's reduction",
         NO_REDUCTION + NO_LOADS),
    ]),
    "row": ("gram_kernel<T, M><<<dim3(Tn, B), kThreads, 0, s>>>", []),
}


def device_ms(fn, reps: int = 50, warm_s: float = 0.5) -> float:
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


def runner(design: str, path: Path, dF, R, mask):
    """A call of the Gram kernel of the library built from ``path``."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import taa_update as k

    lib = build.load(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    B, m, T, D = dF.shape
    G = torch.empty((B, T, m, m), dtype=torch.float32, device=dF.device)
    u = torch.empty((B, T, m), dtype=torch.float32, device=dF.device)
    stream = build.stream_of(dF)
    if design == "row":
        lib.taa_gram_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
        return lambda: lib.taa_gram_launch(
            dF.data_ptr(), R.data_ptr(), mask.data_ptr(), G.data_ptr(),
            u.data_ptr(), B, m, T, D, 0, 0, stream)
    lib.taa_gram_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
    info = (ctypes.c_int * 4)()
    return lambda: k._build.raise_on(lib.taa_gram_launch(
        dF.data_ptr(), R.data_ptr(), mask.data_ptr(), G.data_ptr(),
        u.data_ptr(), info, B, m, T, D, 0, 0, stream), "taa_gram (ablation)")


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import taa_update as k

    parser = argparse.ArgumentParser()
    parser.add_argument("--source", type=Path, action="append")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("taa_gram_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out_dir = ROOT / "build" / "gram_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for n, src in enumerate(args.source or [k.SOURCE]):
        source = src.read_text()
        design = next((d for d, (marker, _) in DESIGNS.items()
                       if marker in source), None)
        if design is None:
            raise RuntimeError(f"{src}: not a design this tool knows")
        path = out_dir / f"taa_update_{n}_{design}.cu"
        path.write_text(source)
        runs.append((design, f"{src.name} as it is", path))
        for i, (name, edits) in enumerate(DESIGNS[design][1]):
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"ablation {name!r}: its text is not "
                                       f"in the source once")
                text = text.replace(old, new)
            path = out_dir / f"taa_update_{n}_{design}_ablation{i}.cu"
            path.write_text(text)
            runs.append((design, name, path))
    build.build_all(tuple(path for _, _, path in runs))  # nvcc in parallel
    rng = np.random.default_rng(1)
    B, m, T, D = 2, 3, 25, 4096

    def t(*shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()

    t(B, T, D, scale=1.0)                       # x, as chip_smoke.py draws
    R = t(B, T, D, scale=0.3)
    t(B, m, T, D, scale=0.1)                    # dX
    dF = t(B, m, T, D, scale=0.1)
    mask = torch.ones(B, T, device="cuda")
    for _ in range(2):                          # each twice, in turns
        for design, name, path in runs:
            ms = device_ms(runner(design, path, dF, R, mask))
            print(f"{design} f32 B={B} m={m} T={T} D={D} {name}: device ms "
                  f"per call {ms}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
