#!/usr/bin/env python3
"""Where a DiT-XL train step's time goes on the card.

    python3 tools/train_step_profile.py [--batch 16] [--steps 3] [--index-layers]

Builds DiT-XL at full width (random weights from numpy seed 0, float32,
TF32 off, as ``chip_smoke.py`` phase 6 trains it), its AdamW state and
``repro_torch.launch.steps.make_train_step``, runs two steps to warm up,
then ``--steps`` steps without the profiler and ``--steps`` under
torch.profiler, on the batches ``launch/train.py`` makes
(``LatentPipeline``, 16 tokens).  Without the profiler, each step's call
runs under ``torch.cuda.set_sync_debug_mode("error")`` (a wait for the
card inside it raises), and it prints per step (medians): the wall, the
host's enqueue time (the call's start to its return: no wait in it, so
host work only) and the device time of forward+backward and of the update
(CUDA events, split at the step's ``mark``).  Under the profiler: the
device's busy time (the union of its kernels' spans) and idle share, the
device time by kind of kernel (GEMM, elementwise, reduction, softmax,
indexing, copies, other) and the kernels with the most device time; and
the AdamW update's bytes (each of grads, mu, nu, master read once, mu,
nu, master and params written once) against its time.

``--index-layers`` takes ``dit_apply``'s ``unbind`` out (the function's
text with ``v.unbind(0)`` replaced by ``v``, compiled in its module): each
layer then indexes the stacked (L, ...) leaves, whose backward fills a
zero copy of the whole stack per layer and sums the L copies.  The result
is the same; only the time differs.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
#: kernel kinds, by the first fragment of the kernel's name that matches
KINDS = (("gemm", ("gemm", "cutlass", "xmma", "ampere_", "sm90_")),
         ("softmax", ("softmax",)),
         ("reduction", ("reduce", "norm")),
         ("indexing", ("index", "gather", "scatter", "embedding")),
         ("elementwise", ("elementwise", "vectorized", "unrolled")),
         ("copy", ("copy", "memcpy", "memset", "fill")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, marks in KINDS:
        if any(m in low for m in marks):
            return kind
    return "other"


def union_ms(spans) -> float:
    """Total length of the union of (start, end) spans, in ms (us in)."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def index_layers() -> None:
    """``dit_apply`` with its ``unbind`` taken out (see the module's doc)."""
    import inspect
    import textwrap

    from repro_torch.diffusion import dit

    src = textwrap.dedent(inspect.getsource(dit.dit_apply))
    ablated = src.replace("v.unbind(0)", "v")
    if ablated == src:
        raise SystemExit("dit_apply has no unbind to take out")
    exec(compile(ablated, dit.__file__, "exec"), dit.__dict__)


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--index-layers", action="store_true",
                   help="take dit_apply's unbind out (an ablation)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA device", file=sys.stderr)
        return 1

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import LatentPipeline
    from repro_torch.device import to_device
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import build_state
    from repro_torch.tree import leaves

    if args.index_layers:
        index_layers()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    cfg = get_arch("dit-xl")
    params, opt = build_state(cfg, 0, cuda)
    step_fn = S.make_train_step(cfg, total_steps=100)
    pipe = LatentPipeline(num_tokens=16, latent_dim=cfg.latent_dim,
                          num_classes=cfg.num_classes, seed=0)
    dtypes = {"latents": torch.float32, "noise": torch.float32,
              "labels": torch.int32, "t": torch.int32}

    def batch(step):
        return {k: to_device(v, dtypes[k], cuda)
                for k, v in pipe.batch(step, args.batch).items()}

    state = {"params": params, "opt": opt}

    def run(step, strict=False):
        """One step: (wall ms, host enqueue ms, device ms of
        forward+backward, of the update)."""
        t0 = time.monotonic()
        b = batch(step)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state["params"], state["opt"], m = step_fn(
                state["params"], state["opt"], b,
                to_device(step, torch.int32, cuda), mark=ev[1].record)
            ev[2].record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        enqueue = time.monotonic() - t0
        float(m["loss"])
        return ((time.monotonic() - t0) * 1e3, enqueue * 1e3,
                ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))

    for step in range(2):
        run(step)
    plain = [run(step, strict=True) for step in range(2, 2 + args.steps)]
    med = [statistics.median(r[i] for r in plain) for i in range(4)]
    label = "unbind taken out, " if args.index_layers else ""
    print(f"DiT-XL train step ({label}batch {args.batch} x 16 tokens, "
          f"float32, TF32 off), {args.steps} steps without the profiler, "
          f"each under sync-debug mode \"error\": wall {med[0]} ms, host "
          f"enqueue {med[1]} ms, device forward+backward {med[2]} ms, "
          f"update {med[3]} ms (medians)")
    torch.cuda.synchronize()
    walls, splits = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for step in range(2 + args.steps, 2 + 2 * args.steps):
            wall, _, fb, up = run(step)
            walls.append(wall)
            splits.append((fb, up))
    torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.time_range.end
              > e.time_range.start]
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    n = args.steps
    busy = union_ms(spans)
    first = min(a for a, _ in spans)
    last = max(b for _, b in spans)
    by_kind, by_name = {}, {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    wall = statistics.median(walls)
    fb = statistics.median(s[0] for s in splits)
    up = statistics.median(s[1] for s in splits)
    nparams = sum(x.numel() for x in leaves(state["params"]))
    update_bytes = 8 * 4 * nparams  # grads, mu, nu, master in; mu, nu,
    # master, params out (float32)
    print(f"{nparams} parameters, {n} profiled steps: wall {wall} ms "
          f"(median), device forward+backward {fb} ms, update {up} ms "
          f"(CUDA events, median); {len(events) / n} kernel launches and "
          f"copies a step, busy {busy / n} ms a step, "
          f"device idle share {1 - busy / ((last - first) / 1e3)} from the "
          f"first kernel's start to the last one's end")
    print(f"update: {update_bytes} B at least (bound "
          f"{update_bytes / HBM_BYTES_PER_S * 1e3} ms at 3.35 TB/s), "
          f"{update_bytes / (up / 1e3) / 1e12} TB/s achieved")
    total = sum(by_kind.values())
    print("device ms a step by kind: " + "; ".join(
        f"{k} {v / n} ({v / total})" for k, v in
        sorted(by_kind.items(), key=lambda kv: -kv[1])))
    print("kernels with the most device time (ms a step, calls a step):")
    counts = {}
    for e in events:
        counts[e.name] = counts.get(e.name, 0) + 1
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms / n} ms, {counts[name] / n} calls: [{kind_of(name)}] "
              f"{name[:110]}")
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
