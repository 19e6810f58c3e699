#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), end to end.

    python3 chip_smoke.py

Phases (each prints its lines; any failed check raises, so the exit code
is not 0):

1. device and build: the card's name and power limit from nvidia-smi, then
   every kernel library compiled from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, all started together; build seconds and the compiler's
   register report, summed for the redesigned kernels); the wgmma attention
   kernel's SASS must hold HGMMA and UTMALDG instructions, the TF32
   attention kernel's and the SSD scan's HMMA (where cuobjdump is found);
2. each TAA-update kernel against its plain PyTorch version on the card, at the main
   path's shapes (B=2 lanes, m=3, T=25, D=4096 = 256 tokens x latent 16),
   float32 and bfloat16, a ragged D=4000, every round mode with a nonzero
   guard, and the round at m=8, T=1000 (its Gram partials in device
   memory); the Gram kernel's grid (one CTA per tile, as ``gram_plan``
   says) and the round's cooperative grid printed (CTAs, tiles, CTAs the
   card holds at once; more CTAs than lanes), each two runs bit for bit;
   then kernel / plain / library times (CUDA events, median of 25
   windows; and device time from torch.profiler) beside the least time
   the card could take; the Gram kernel's library call computes G and u
   together (the stack of its inputs made outside the timed call);
3. the main path at full DiT-XL width (28 layers, d 1152, 16 x 72 heads,
   d_ff 4608, 256 tokens), random weights from a numpy seed, float32 with
   TF32 off: 2 requests served in one batch through the serving entry
   points with ParaTAA staged, ParaTAA fused, and sequential DDIM (T=25),
   each solve under ``torch.cuda.set_sync_debug_mode("error")`` (any wait
   on the card but the solver's counted poll raises).  Checks: every
   ParaTAA request converged, ParaTAA's x0 within 2e-2 relative of
   sequential, staged and fused within 1e-4 relative, each kernel's
   launches during its run equal to the device iterations, and the
   engine's blocking polls equal to the device iterations + 1 (ParaTAA)
   or 1 (sequential).  Then one fused dispatch under torch.profiler: the
   device's idle share of the solve and the host's share of "rest";
4. the model kernels (flash attention, GQA flash decode with a bf16 and an
   int8 cache, Mamba2 SSD scan, RG-LRU scan) driven once each through
   ``repro_torch.kernels.ops`` (``flash_decode`` for int8) at the full
   widths of DiT-XL, qwen3-0.6b, recurrentgemma-2b and mamba2-1.3b, every
   launch count set to 0 just before and checked equal to what the calls
   should launch just after (the wgmma attention kernel for bf16, the TF32
   one for float32; the decode's split pass, and its combine pass where the
   cache is split; the SSD scan's chunk and state-pass launches); each
   case's path, split count, chunk or tile plan printed (the RG-LRU scan's
   tiles, segments, chains and cooperative grid);
   each output against its plain version on the same inputs (the JAX
   tests' bounds) and run again bit for bit; then kernel / plain / library
   times and achieved TFLOP/s and TB/s beside the least time the card could
   take (for the TF32 attention and the SSD scan also the float32 bound of
   their earlier CUDA-core designs);
5. the serving stack on the same DiT-XL (``repro_torch.serving`` built as
   ``serve.py --serve-async --steps-T 25 --mixed-keys 2 --fuse-round
   --batch-size 2 --chunk-iters 2`` builds it, keys (dit-xl, 25, taa) and
   (dit-xl, 12, taa), each warmed with one request): 6 requests as a
   closed-loop burst (half with tau 1e-2) in a synchronous stepwise drain,
   each ``stepwise_step`` and ``stepwise_refill`` under sync-debug mode
   "error", K3's launch count set to 0 just before the drain and checked
   equal to its device iterations just after.  Checks: every ticket
   resolved and none failed; each trajectory within 1e-4 relative of
   ``run_batch`` of the same requests on a fresh engine (iters beside),
   x0 within 2e-2 of ``sequential_sample``; one blocking poll a round and
   ``stepwise_traces`` 5 per key.  Prints per key rounds, refills,
   wasted_iter_frac (beside the whole-batch run's), device NFE, bytes a
   round, ticket latency p50/p95, each chunk's device ms (CUDA events)
   against ``stepwise_step``'s host ms, and the device's idle share over
   the drain.  Then 2 requests through a threaded stepwise loop and 2
   through a threaded whole-batch loop (``start``/``stop``; readiness by
   ``PendingBatch.ready()``), every ticket resolved;
6. train -> checkpoint -> serve at DiT-XL's full width, on a card freed of
   the earlier phases' params and engines, through the drivers' entry
   points (``repro_torch.launch.train``, ``serve.main --ckpt``): run A
   trains 2 steps (batch 16 of 16 tokens, as the reference trains) and
   saves step 2; run B resumes from it, runs steps 2-3 and saves step 4;
   run C trains 4 steps without checkpoints.  Every launch count set to 0
   just before each run and read just after (training launches no kernel
   of the port).  Checks: B resumed at step 2 and ran 2 steps; its losses
   within 1e-5 relative of C's steps 2-3; the step-4 params read back
   equal B's in memory (``torch.equal``); then ``serve.main --ckpt`` with
   ParaTAA (fused: K3 launched once per iteration) and sequential DDIM,
   T=25, 2 requests: every ParaTAA request converged, x0 within 2e-2 of
   sequential.  Prints the disk's usage before the first save, the
   checkpoint's bytes and its write and read seconds, each step's wall
   and device ms split into forward+backward and update (CUDA events),
   and peak memory.  The checkpoint directory (``build/chip_smoke_ckpt``)
   is deleted at the end.

Then one JSON line of per-kernel numbers, and last the line
``{"ok": true, "device": {...}}``.  Without CUDA, or run from a directory
without the repository's ``src/``, it fails before printing any result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# main-path geometry: DDIM T=25, ParaTAA order 8, history 3, 2 requests of
# DiT-XL's 256 latent tokens
T_STEPS, ORDER_K, HISTORY_M, REQUESTS, NUM_TOKENS = 25, 8, 3, 2, 256
# scale of the adaLN-zero leaves (ada, final_ada, out_proj): with the
# reference's zeros eps is identically 0 and the DiT never shapes the solve
ADA_SCALE = 0.02
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12       # H100 SXM float32, outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_TC_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {name: CSRC + f"{name}.cu" for name in (
    "flash_attention", "flash_attention_tc", "flash_decode", "ssd_scan",
    "rglru_scan")}
SOURCES.update({name: CSRC + "taa_update.cu"
                for name in ("taa_gram", "taa_apply", "taa_round")})
REPLACES = {"taa_gram": "src/repro/kernels/taa_update.py:68",
            "taa_apply": "src/repro/kernels/taa_update.py:116",
            "taa_round": "src/repro/kernels/taa_update.py:239",
            "flash_attention": "src/repro/kernels/flash_attention.py:97",
            "flash_attention_tc": "src/repro/kernels/flash_attention.py:97",
            "flash_decode": "src/repro/kernels/flash_decode.py:105",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:87",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:51"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, *, warmup: int = 3, samples: int = 25, reps: int = 10):
    """Median over ``samples`` CUDA-event windows of ``reps`` calls each,
    per call, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def device_ms(fn, *, reps: int = 25):
    """Device time per call in ms from torch.profiler: the summed durations
    of every kernel (and copy) the calls put on the card, so host launch
    overhead is left out.  None when the profiler sees no device work."""
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
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) / 1e3 / reps if spans else None


def ptxas_summary(lib) -> str:
    """Registers and spill bytes of every kernel in a library, from the
    compiler's report kept beside it."""
    import re

    text = lib.with_suffix(".log").read_text()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
    return (f"{len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
            f"{sum(x > 0 for x in spills)} with spill stores (at most "
            f"{max(spills)} bytes)")


def check_sass(lib, name: str, ops) -> None:
    """A tensor-core kernel's SASS holds the instructions its design rests
    on: warpgroup MMAs (HGMMA) and TMA loads (UTMALDG) for the wgmma
    attention kernel, mma.sync (HMMA) for the TF32 attention kernel and the
    SSD scan.  Checked where cuobjdump is found."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        print(f"SASS of {name}: not checked (no cuobjdump)")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: sum(op in line for line in sass.splitlines()) for op in ops}
    print(f"SASS of {name}: {counts} instructions")
    check(all(n > 0 for n in counts.values()),
          f"{name} SASS lacks one of {ops}: {counts}")


# --- phase 2: kernels against their plain versions --------------------------


def kernel_inputs(dtype, D, *, B=2, m=HISTORY_M, T=T_STEPS, seed=1,
                  window_from=4, guard_rows=3):
    """Main-path-shaped inputs on the card, made from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).cuda().to(dtype)

    x, R = t(B, T, D), t(B, T, D, scale=0.3)
    dX, dF = t(B, m, T, D, scale=0.1), t(B, m, T, D, scale=0.1)
    rows = torch.arange(T, device="cuda")
    mask = (rows >= window_from).float().expand(B, T).contiguous()
    guard = (rows >= T - guard_rows).float().expand(B, T).contiguous()
    gamma = t(B, T, m, scale=0.1).float()
    return dict(x=x, R=R, dX=dX, dF=dF, mask=mask, guard=guard, gamma=gamma)


def check_kernels():
    """Every kernel against its plain version: f32 and bf16, D = 4096 and a
    ragged 4000, every round mode, a nonzero guard.  Returns the largest
    float32 error per kernel at the main-path width."""
    import torch

    from repro_torch.kernels import ref, taa_update as k

    worst = {"taa_gram": 0.0, "taa_apply": 0.0, "taa_round": 0.0}
    grid = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        for D in (4096, 4000):
            a = kernel_inputs(dtype, D)
            G, u = k.taa_gram(a["dF"], a["R"], a["mask"])
            Gr, ur = ref.taa_gram_ref(a["dF"], a["R"], a["mask"])
            # a Gram entry sums D products: bound by 2^-16 of the largest
            # sum of absolute products (the magnitude f32 rounding scales with)
            Ga, ua = ref.taa_gram_ref(a["dF"].abs(), a["R"].abs(), a["mask"])
            tol_g = 2.0 ** -16 * max(float(Ga.max()), float(ua.max()), 1.0)
            err_g = max(float((G - Gr).abs().max()),
                        float((u - ur).abs().max()))
            gram_grid = dict(k.last_gram_grid)
            G2, u2 = k.taa_gram(a["dF"], a["R"], a["mask"])
            check(torch.equal(G, G2) and torch.equal(u, u2),
                  f"taa_gram {name} D={D}: two runs differ")
            plan = k.gram_plan(*a["dF"].shape, a["dF"].element_size())
            print(f"taa_gram grid {name} D={D}: {gram_grid['ctas']} CTAs of "
                  f"{gram_grid['threads']} threads in clusters of "
                  f"{gram_grid['cluster']} (one a row) over "
                  f"{gram_grid['tiles_per_row']} tiles of {k.ROUND_TILE} "
                  f"elements a row, {plan['vector']}-element vectors; two "
                  f"runs bit for bit")
            check(gram_grid == {key: plan[key] for key in (
                "ctas", "tiles_per_row", "threads", "cluster")},
                f"taa_gram grid {gram_grid} != plan {plan}")
            out = k.taa_apply(a["x"], a["R"], a["dX"], a["dF"], a["gamma"],
                              a["mask"])
            want = ref.taa_apply_ref(a["x"], a["R"], a["dX"], a["dF"],
                                     a["gamma"], a["mask"])
            err_a = float((out.float() - want.float()).abs().max())
            errs_r = []
            for mode in ("taa", "aa", "aa+"):
                out = k.taa_round(a["x"], a["R"], a["dX"], a["dF"],
                                  a["mask"], a["guard"], mode=mode, lam=1e-6)
                grid = dict(k.last_round_grid)
                again = k.taa_round(a["x"], a["R"], a["dX"], a["dF"],
                                    a["mask"], a["guard"], mode=mode,
                                    lam=1e-6)
                check(torch.equal(out, again),
                      f"taa_round {name} D={D} {mode}: two runs differ")
                want = ref.taa_round_ref(a["x"], a["R"], a["dX"], a["dF"],
                                         a["mask"], a["guard"], mode=mode,
                                         lam=1e-6)
                errs_r.append(float((out.float() - want.float()).abs().max()))
            torch.cuda.synchronize()
            print(f"kernels {name} B=2 m={HISTORY_M} T={T_STEPS} D={D}: "
                  f"taa_gram max_abs_err {err_g} (bound {tol_g}), "
                  f"taa_apply {err_a} (bound {tol}), taa_round taa/aa/aa+ "
                  f"{errs_r} (bound {tol})")
            check(err_g < tol_g, f"taa_gram {name} D={D}: {err_g} >= {tol_g}")
            check(err_a < tol, f"taa_apply {name} D={D}: {err_a} >= {tol}")
            check(max(errs_r) < tol,
                  f"taa_round {name} D={D}: {errs_r} >= {tol}")
            print(f"taa_round grid {name} D={D}: {grid['ctas']} CTAs "
                  f"(one cooperative launch) over {grid['tiles']} tiles of "
                  f"{k.ROUND_TILE} floats, {grid['co_resident']} CTAs "
                  f"co-resident; two runs bit for bit")
            check(grid["ctas"] > a["x"].shape[0],
                  f"taa_round grid {grid} not wider than the lanes")
            if dtype == torch.float32 and D == 4096:
                worst.update(taa_gram=err_g, taa_apply=err_a,
                             taa_round=max(errs_r))
    # m=8, T=1000: 1000 * (64 + 16) floats of G, u per lane, more than a
    # block's shared memory; the Gram partials live in device memory
    a = kernel_inputs(torch.float32, 64, B=1, m=8, T=1000)
    errs = []
    for mode in ("taa", "aa", "aa+"):
        out = k.taa_round(a["x"], a["R"], a["dX"], a["dF"], a["mask"],
                          a["guard"], mode=mode, lam=1e-6)
        want = ref.taa_round_ref(a["x"], a["R"], a["dX"], a["dF"], a["mask"],
                                 a["guard"], mode=mode, lam=1e-6)
        errs.append(float((out - want).abs().max()))
    print(f"taa_round float32 B=1 m=8 T=1000 D=64 taa/aa/aa+: max_abs_err "
          f"{errs} (bound 1e-3, the card test's for T=1000); grid "
          f"{k.last_round_grid}")
    check(max(errs) < 1e-3, f"taa_round m=8 T=1000: {errs}")
    return worst


def bounds(a, active: int):
    """Least time (ms) for each kernel on these inputs: the bytes it must
    move (each input read once, each output written once; masked-off rows
    need no history/residual bytes) over HBM bandwidth, and its float32
    operations over the float32 peak; the larger, with which bounds it."""
    B, m, T, D = a["dF"].shape
    e = a["dF"].element_size()
    f4 = 4
    gram_bytes = B * active * (m + 1) * D * e + B * T * f4 \
        + B * T * (m * m + m) * f4
    gram_ops = B * active * D * (2 * (m * (m + 1) // 2 + m) + m + 1)
    apply_bytes = 2 * B * T * D * e + B * active * (1 + 2 * m) * D * e \
        + B * T * (m + 1) * f4
    apply_ops = B * active * D * (3 * m + 2)
    round_bytes = 2 * B * T * D * e + B * active * (1 + 2 * m) * D * e \
        + 2 * B * T * f4
    round_ops = gram_ops + apply_ops + B * T * (T * (m * m + m) + 2 * m ** 3)
    out = {}
    for name, nbytes, ops in (("taa_gram", gram_bytes, gram_ops),
                              ("taa_apply", apply_bytes, apply_ops),
                              ("taa_round", round_bytes, round_ops)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, ops=ops)
    return out


def time_kernels():
    """Kernel, plain and library times at the main path's float32 shapes
    with every row in the window (the first iteration's mask)."""
    import torch

    from repro_torch.kernels import ref, taa_update as k

    a = kernel_inputs(torch.float32, 4096, window_from=0, guard_rows=1)
    x, R, dX, dF, mask, guard, gamma = (a[n] for n in (
        "x", "R", "dX", "dF", "mask", "guard", "gamma"))
    # K1's yardstick: one PyTorch call computing G and u together, the
    # (m+1)-stream stack [dF; R] with itself (it adds R.R); the stack is
    # made here, outside the timed call, and every row is active, so the
    # mask is the identity
    stack = torch.cat([dF, R[:, None]], dim=1)
    calls = {
        "taa_gram": (lambda: k.taa_gram(dF, R, mask),
                     lambda: ref.taa_gram_ref(dF, R, mask),
                     lambda: torch.einsum("bitd,bjtd->btij", stack, stack)),
        "taa_apply": (lambda: k.taa_apply(x, R, dX, dF, gamma, mask),
                      lambda: ref.taa_apply_ref(x, R, dX, dF, gamma, mask),
                      None),
        "taa_round": (lambda: k.taa_round(x, R, dX, dF, mask, guard,
                                          mode="taa", lam=1e-8),
                      lambda: ref.taa_round_ref(x, R, dX, dF, mask, guard,
                                                mode="taa", lam=1e-8),
                      None),
    }
    bnd = bounds(a, active=T_STEPS)
    times = {}
    for name, fns in calls.items():
        # CUDA-event wall per call (what a caller waits, launch overhead
        # included) and profiler device time per call (the card's work)
        wall = [cuda_ms(f) if f else None for f in fns]
        dev = [device_ms(f) if f else None for f in fns]
        times[name] = dict(ms=wall[0], plain_ms=wall[1], library_ms=wall[2],
                           device_ms=dev[0], plain_device_ms=dev[1],
                           library_device_ms=dev[2])
        print(f"time {name} f32 B=2 m={HISTORY_M} T={T_STEPS} D=4096: "
              f"kernel {wall[0]} ms (device {dev[0]} ms), plain {wall[1]} ms "
              f"(device {dev[1]} ms), library {wall[2]} ms (device {dev[2]} "
              f"ms), bound {bnd[name]['bound_ms']} ms by "
              f"{bnd[name]['bound_by']} ({bnd[name]['bytes']} B, "
              f"{bnd[name]['ops']} flop)")
    return times, bnd


# --- phase 3: the main path at full DiT-XL width ----------------------------


class TimedEps:
    """Wraps the engine's eps_apply with CUDA events around each DiT call."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, params, x, taus, labels):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(params, x, taus, labels)
        stop.record()
        self.events.append((start, stop))
        return out

    def total_ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def main_path():
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import ddim_coeffs
    from repro_torch.diffusion.convert import dit_init
    from repro_torch.sampling import SampleRequest, get_sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("dit-xl")
    t0 = time.monotonic()
    params = dit_init(cfg, SEED, torch.device("cuda"), ada_scale=ADA_SCALE)
    torch.cuda.synchronize()
    print(f"DiT-XL params: {cfg.num_layers} layers d={cfg.d_model} "
          f"{cfg.num_heads}x{cfg.head_dim} d_ff={cfg.d_ff} {NUM_TOKENS} tokens x "
          f"latent {cfg.latent_dim}, float32, numpy seed {SEED}, adaLN-zero "
          f"leaves N(0, {ADA_SCALE}^2), made in {time.monotonic() - t0} s")
    coeffs = ddim_coeffs(T_STEPS)
    rng = np.random.default_rng(SEED)
    requests = [SampleRequest(label=int(rng.integers(0, cfg.num_classes)),
                              seed=int(rng.integers(1 << 30)))
                for _ in range(REQUESTS)]
    taa = dict(order_k=ORDER_K, history_m=HISTORY_M)
    runs = {}
    for label, spec in (
            ("taa staged", get_sampler("taa", **taa)),
            ("taa fused", get_sampler("taa", fuse_round=True, **taa)),
            ("seq", get_sampler("seq"))):
        runs[label] = serve_once(label, params, cfg, coeffs, spec, requests)
    # traced after the counted runs: each round's first call (library
    # handles, lazily loaded kernels) is behind it
    for label, fuse in (("fused", True), ("staged", False)):
        runs[f"trace {label}"] = trace_dispatch(
            label, params, cfg, coeffs,
            get_sampler("taa", fuse_round=fuse, **taa), requests)
    return runs, params, cfg


def strict_solves(engine, profiled: bool = False):
    """Runs each of ``engine``'s solves (not the packing, not ``collect``)
    under ``torch.cuda.set_sync_debug_mode("error")``: any wait on the card
    other than the solver's counted poll (an event wait, which the mode
    does not flag) raises.  ``profiled`` marks each solve's span for a
    profiler trace."""
    import torch
    from torch.profiler import record_function

    solve = engine._solve

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            if profiled:
                with record_function("solve"):
                    return solve(*args, **kw)
            return solve(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    engine._solve = strict
    return engine


def serve_once(label, params, cfg, coeffs, spec, requests):
    """One run of the serving path through ``SamplingEngine.run_batch``,
    every launch count set to 0 just before it and read just after; each
    solve under sync-debug mode (``strict_solves``)."""
    import torch

    from repro_torch.kernels import taa_update
    from repro_torch.launch import serve
    from repro_torch.sampling import SamplingEngine

    timed = TimedEps(serve.make_eps_apply(cfg))
    engine = strict_solves(SamplingEngine(
        timed, params, coeffs, spec,
        sample_shape=(NUM_TOKENS, cfg.latent_dim),
        device=torch.device("cuda")))
    taa_update.reset_launches()
    results = engine.run_batch(requests, batch_size=REQUESTS)
    launches = dict(taa_update.launches)
    d = engine.last_dispatches[0]
    dit_ms = timed.total_ms()
    iters = max(d["device_iters"], 1)
    print(f"{label}: " + "; ".join(
        f"label={r.request.label} iters={r.iters} nfe={r.nfe} "
        f"converged={r.converged}" for r in results)
        + f"; dispatch wall {d['wall_s']} s over {d['device_iters']} device "
          f"iterations; DiT {dit_ms / iters} ms/iter on the card, the rest "
          f"(update, bookkeeping, host) {d['wall_s'] * 1e3 / iters - dit_ms / iters}"
          f" ms/iter; update launches (modeled) {d['update_launches']}; "
          f"kernel launches {launches}; blocking polls {d['blocking_polls']}"
          f", host fetch {d['host_fetch_bytes']} B (solve under sync-debug "
          f"mode \"error\": no other wait)")
    polls = 1 if spec.is_sequential else d["device_iters"] + 1
    check(d["blocking_polls"] == polls,
          f"{label}: {d['blocking_polls']} blocking polls, want {polls}")
    return dict(results=results, device_iters=d["device_iters"],
                launches=launches, wall_s=d["wall_s"], dit_ms=dit_ms,
                blocking_polls=d["blocking_polls"],
                host_fetch_bytes=d["host_fetch_bytes"])


def trace_dispatch(label, params, cfg, coeffs, spec, requests):
    """One dispatch under torch.profiler.  The device's idle time, when it
    waits for the host, read two ways: at the polls, by CUDA events
    recorded just before each poll's wait and just after it (the card has
    finished the iteration's work at the first and is idle until the
    second and the next launch); and as the solve's span less the union of
    the kernels' spans that the profiler recorded (an undercount of
    busy time when records are missing: flagged where the idle time would
    exceed "rest", the solve wall minus the DiT's CUDA-event time).  Its
    share of the solve, and the host's share of "rest".  Also the host
    time of the Anderson update (its calls marked "update"), its device
    kernels and the host ops with the most self time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import parataa
    from repro_torch.launch import serve
    from repro_torch.sampling import SamplingEngine

    timed = TimedEps(serve.make_eps_apply(cfg))
    engine = strict_solves(SamplingEngine(
        timed, params, coeffs, spec,
        sample_shape=(NUM_TOKENS, cfg.latent_dim),
        device=torch.device("cuda")), profiled=True)
    update, poll = parataa.anderson_update, parataa.poll_finished
    waits = []

    def marked_update(*args, **kw):
        with record_function("update"):
            return update(*args, **kw)

    def timed_poll(state):
        before = torch.cuda.Event(enable_timing=True)
        after = torch.cuda.Event(enable_timing=True)
        before.record()
        done = poll(state)
        after.record()
        waits.append((before, after))
        return done

    parataa.anderson_update, parataa.poll_finished = marked_update, timed_poll
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.run_batch(requests, batch_size=REQUESTS)
    finally:
        parataa.anderson_update, parataa.poll_finished = update, poll
    torch.cuda.synchronize()
    poll_idle = sum(a.elapsed_time(b) for a, b in waits)
    events = prof.events()
    span = next(e.time_range for e in events if e.name == "solve")
    updates = [e for e in events if e.name == "update"]
    update_ms = sum(e.time_range.elapsed_us() for e in updates) / 1e3

    def launched(e):              # the device kernels an op and its callees
        return list(e.kernels) + [k for c in e.cpu_children
                                  for k in launched(c)]

    def callees(e):
        return [e] + [d for c in e.cpu_children for d in callees(c)]

    kernels, ops = {}, {}
    for k in (k for e in updates for k in launched(e)):
        kernels[k.name] = kernels.get(k.name, 0.0) + k.duration / 1e3
    for op in (d for e in updates for d in callees(e)[1:]):
        ops[op.name] = ops.get(op.name, 0.0) + op.self_cpu_time_total / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])
    spans = sorted((max(e.time_range.start, span.start),
                    min(e.time_range.end, span.end)) for e in events
                   if e.device_type == DeviceType.CUDA)
    check(bool(spans), "trace: the profiler saw no device work")
    busy, end = 0.0, span.start
    for a, b in spans:          # the union of the device's spans
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = (span.end - span.start) / 1e3
    busy /= 1e3
    dit = timed.total_ms()
    iters = max(engine.last_dispatches[0]["device_iters"], 1)
    rest = wall - dit
    idle = wall - busy
    short = " (more than the rest: kernel records missing, not used)" \
        if idle > rest else ""
    print(f"trace ({label}, one dispatch under torch.profiler): solve "
          f"{wall} ms over {iters} iterations; device idle at the {len(waits)}"
          f" polls (CUDA events) {poll_idle} ms: device idle share "
          f"{poll_idle / wall}; DiT {dit / iters} ms/iter, rest "
          f"{rest / iters} ms/iter, of which the host (device idle at the "
          f"polls) {poll_idle / iters} ms/iter: host share of rest "
          f"{poll_idle / rest}; by the profiler's kernel spans, busy {busy} "
          f"ms, idle {idle} ms, share {idle / wall}{short}; "
          f"the update's host time {update_ms / iters} ms/iter, its device "
          f"kernels {sum(kernels.values()) / iters} ms/iter, the longest "
          f"(ms/iter): "
          + "; ".join(f"{name[:60]} {ms / iters}" for name, ms in top[:5])
          + "; the host ops with the most self time (ms/iter): "
          + "; ".join(f"{name[:60]} {ms / iters}" for name, ms in top_ops[:5]))
    return dict(solve_ms=wall, idle_share=poll_idle / wall,
                host_share_of_rest=poll_idle / rest)


def check_main_path(runs):
    import numpy as np

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    seq = runs["seq"]["results"]
    for label in ("taa staged", "taa fused"):
        for r, s in zip(runs[label]["results"], seq):
            check(r.converged, f"{label}: request {r.request} did not converge")
            check(r.trajectory.shape == (T_STEPS + 1, NUM_TOKENS, 16)
                  and np.all(np.isfinite(r.trajectory)),
                  f"{label}: trajectory shape/finiteness")
            err = rel(r.x0, s.x0)
            print(f"{label} label={r.request.label}: x0 vs sequential rel err "
                  f"{err} (bound 2e-2)")
            check(err < 2e-2, f"{label}: ParaTAA x0 vs sequential {err}")
    for a, b in zip(runs["taa staged"]["results"],
                    runs["taa fused"]["results"]):
        err = rel(b.trajectory, a.trajectory)
        print(f"fused vs staged label={a.request.label}: trajectory rel err "
              f"{err} (bound 1e-4)")
        check(err < 1e-4, f"fused vs staged {err}")
    staged, fused = runs["taa staged"], runs["taa fused"]
    n_s, n_f = staged["device_iters"], fused["device_iters"]
    check(staged["launches"] == {"taa_gram": n_s, "taa_apply": n_s,
                                 "taa_round": 0},
          f"staged launches {staged['launches']} != {n_s} device iterations")
    check(fused["launches"] == {"taa_gram": 0, "taa_apply": 0,
                                "taa_round": n_f},
          f"fused launches {fused['launches']} != {n_f} device iterations")
    check(runs["seq"]["launches"] == {"taa_gram": 0, "taa_apply": 0,
                                      "taa_round": 0}, "seq launched kernels")


# --- phase 5: the serving stack, stepwise, at full DiT-XL width -------------

# two keys (--mixed-keys 2): (dit-xl, 25, taa) and its half depth, both
# fused; 2 lanes a key, 2 solver iterations a round
SERVE_SLOTS, SERVE_CHUNK = 2, 2
# (key index, tau) of the closed-loop burst: half the requests carry a
# looser tau
SERVE_TRAFFIC = ((0, None), (1, None), (0, 1e-2), (1, 1e-2), (0, None),
                 (1, 1e-2))


def serve_args():
    """The CLI flags phase 5 serves with (``serve.py --serve-async
    --steps-T 25 --mixed-keys 2 --fuse-round --batch-size 2
    --chunk-iters 2``)."""
    import argparse

    return argparse.Namespace(
        arch="dit-xl", steps_T=T_STEPS, solver="taa", mixed_keys=2,
        sampler="ddim", order_k=ORDER_K, history_m=HISTORY_M, window=0,
        fuse_round=True, batch_size=SERVE_SLOTS, chunk_iters=SERVE_CHUNK)


class RoundTimer:
    """Wraps one engine's ``stepwise_step``/``stepwise_refill``/
    ``stepwise_poll`` (after warmup): each step and refill runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (the drain is synchronous,
    and the mode is process-wide); CUDA events before and after each
    step's launches time its chunk on the device, a host clock its call;
    CUDA events before and after each poll's wait time the device's idle
    at the poll.  ``log`` collects every timer's chunks in the order they
    were queued (one stream: the device runs them in that order)."""

    def __init__(self, engine, log: list, strict: bool = True):
        import torch

        self.chunks, self.waits, self.log = [], [], log
        self.engine = engine
        step, refill, poll = (engine.stepwise_step, engine.stepwise_refill,
                              engine.stepwise_poll)

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def checked(fn, *args):
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        def timed_step(bank):
            start, t0 = event(), time.perf_counter()
            checked(step, bank)
            host = time.perf_counter() - t0
            self.chunks.append((start, event(), host))
            self.log.append(self.chunks[-1])

        def timed_poll(bank):
            waits = bank.poll_cache is None and bank.summary is not None
            before = event() if waits else None
            out = poll(bank)
            if waits:
                self.waits.append((before, event()))
            return out

        engine.stepwise_step = timed_step
        engine.stepwise_refill = lambda *args: checked(refill, *args)
        engine.stepwise_poll = timed_poll

    def restore(self) -> None:
        """The engine's own methods again (the instance attributes go)."""
        for name in ("stepwise_step", "stepwise_refill", "stepwise_poll"):
            delattr(self.engine, name)

    def summary(self):
        import torch

        torch.cuda.synchronize()
        chunk_ms = [a.elapsed_time(b) for a, b, _ in self.chunks]
        host_ms = [h * 1e3 for _, _, h in self.chunks]
        wait_ms = [a.elapsed_time(b) for a, b in self.waits]
        return chunk_ms, host_ms, wait_ms


def serving_path(params, cfg, device, num_tokens=NUM_TOKENS):
    """Phase 5: the port's serving stack (``serve.make_engine_factory``,
    ``mixed_engine_keys``, ``EngineRegistry.warmup``, ``ServingLoop``) on
    the configuration of ``serve_args``: a synchronous stepwise drain of
    ``SERVE_TRAFFIC`` with K3's launch count set to 0 just before it and
    read just after, then a threaded stepwise run and a threaded
    whole-batch run of 2 requests each."""
    import numpy as np
    import torch

    from repro_torch.kernels import taa_update
    from repro_torch.launch import serve
    from repro_torch.sampling import SampleRequest
    from repro_torch.serving import (Batcher, BatchingPolicy, EngineRegistry,
                                     RequestQueue, ServingLoop)

    args = serve_args()
    keys = serve.mixed_engine_keys(args)
    factory = serve.make_engine_factory(cfg, params, args, device,
                                        num_tokens=num_tokens)
    registry = EngineRegistry(factory)
    queue = RequestQueue()
    loop = ServingLoop(registry, queue, Batcher(BatchingPolicy(
        max_batch=args.batch_size)), chunk_iters=args.chunk_iters)
    t0 = time.monotonic()
    for key in keys:
        registry.warmup(key, slots=loop.batcher.slots_for(registry.get(key)),
                        chunk_iters=args.chunk_iters)
    print(f"phase 5 keys {[k.describe() for k in keys]} warmed in "
          f"{time.monotonic() - t0} s (one request each)")
    log = []
    timers = {key: RoundTimer(registry.get(key), log,
                              strict=device.type == "cuda") for key in keys}
    rng = np.random.default_rng(SEED + 5)
    requests = [(keys[k], SampleRequest(
        label=int(rng.integers(0, cfg.num_classes)),
        seed=int(rng.integers(1 << 30)), tau=tau))
        for k, tau in SERVE_TRAFFIC]
    taa_update.reset_launches()
    t0 = time.monotonic()
    tickets = [queue.submit(req, key) for key, req in requests]
    loop.drain()
    drain_s = time.monotonic() - t0
    launches = dict(taa_update.launches)
    for timer in timers.values():
        timer.restore()
    failed = []
    for t in tickets:
        try:
            t.result(timeout=0)
        except Exception as error:  # noqa: BLE001 — every failure counts
            failed.append(repr(error))
    check(not failed, f"phase 5: {len(failed)} ticket(s) failed: {failed}")
    reports = loop.bank_reports()
    served = dict(drain_s=drain_s, keys=keys, reports=reports,
                  launches=launches, tickets=tickets, timers=timers,
                  log=log, loop_stats=dict(loop.stats), factory=factory,
                  traces={key: registry.get(key).stats["stepwise_traces"]
                          for key in keys})
    served["threaded"] = threaded_runs(registry, keys[0], cfg)
    return served


def threaded_runs(registry, key, cfg):
    """2 requests through a background stepwise loop (start/stop), then 2
    through a background whole-batch loop (``chunk_iters=0``: the loop
    collects whichever dispatch ``PendingBatch.ready()`` says is done)."""
    from repro_torch.sampling import SampleRequest
    from repro_torch.serving import (Batcher, BatchingPolicy, RequestQueue,
                                     ServingLoop)

    out = {}
    for chunk_iters in (SERVE_CHUNK, 0):
        queue = RequestQueue()
        loop = ServingLoop(registry, queue, Batcher(BatchingPolicy(
            max_batch=SERVE_SLOTS, max_wait_s=0.01)),
            chunk_iters=chunk_iters)
        t0 = time.monotonic()
        with loop:
            tickets = [queue.submit(SampleRequest(label=7 * i + 1,
                                                  seed=100 + i), key)
                       for i in range(2)]
            results = [t.result(timeout=600) for t in tickets]
        label = "stepwise" if chunk_iters else "whole-batch"
        check(loop.stats["completed"] == 2 and loop.stats["failed"] == 0
              and all(r.converged for r in results),
              f"phase 5 threaded {label}: {loop.stats}")
        print(f"phase 5 threaded {label} (start/stop): 2 requests served in "
              f"{time.monotonic() - t0} s, iters {[r.iters for r in results]}"
              f", loop stats {dict(loop.stats)}")
        out[label] = dict(loop.stats)
    return out


def check_serving(served, params, cfg, device, num_tokens=NUM_TOKENS):
    """Phase 5's checks and printout: every ticket against ``run_batch``
    of the same requests on a fresh engine (1e-4 relative, iters beside)
    and x0 against ``sequential_sample`` (2e-2); one blocking poll a round
    and 5 stepwise program kinds per key; K3 launched once per device
    iteration; per key rounds, refills, wasted_iter_frac (and the
    whole-batch run's), device NFE, bytes a round, ticket latency, the
    device's idle share over the drain and a step's host time against its
    chunk's device time."""
    import numpy as np
    import torch

    from repro_torch.diffusion.dit import dit_apply
    from repro_torch.sampling import sequential_sample

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    by_key = {}
    for t in served["tickets"]:
        by_key.setdefault(t.key, []).append(t)
    total_iters = 0
    for key in served["keys"]:
        tickets = by_key[key]
        fresh = served["factory"](key)
        ref = fresh.run_batch([t.request for t in tickets],
                              batch_size=SERVE_SLOTS)
        caps = sum(d["device_iters"] * d["slots"]
                   for d in fresh.last_dispatches)
        whole_wasted = 1.0 - sum(sum(d["iters"])
                                 for d in fresh.last_dispatches) / caps
        coeffs = fresh.coeffs
        for t, r in zip(tickets, ref):
            got = t.result(timeout=0)
            err = rel(got.trajectory, r.trajectory)
            req = t.request
            labels = torch.full((1,), req.label, dtype=torch.long,
                                device=device)

            def eps(x, taus, labels=labels):
                return dit_apply(params, cfg, x, taus,
                                 labels.expand(x.shape[0]))

            with torch.inference_mode():
                x0 = sequential_sample(eps, coeffs,
                                       fresh.draw_request_noise(req)
                                       .to(device))
            seq_err = rel(got.x0, x0.cpu().numpy())
            print(f"phase 5 {key.describe()} label={req.label} tau="
                  f"{req.tau}: stepwise iters {got.iters} nfe {got.nfe} "
                  f"converged={got.converged}, run_batch iters {r.iters} "
                  f"nfe {r.nfe}; trajectory vs run_batch rel err {err} "
                  f"(bound 1e-4); x0 vs sequential rel err {seq_err} "
                  f"(bound 2e-2)")
            check(got.trajectory.shape == (key.T + 1, num_tokens,
                                           cfg.latent_dim)
                  and np.all(np.isfinite(got.trajectory)),
                  f"phase 5 {key.describe()}: trajectory shape/finiteness")
            check(err < 1e-4, f"phase 5 stepwise vs run_batch {err}")
            check(seq_err < 2e-2, f"phase 5 x0 vs sequential {seq_err}")
        rep = served["reports"][key]
        chunk_ms, host_ms, wait_ms = served["timers"][key].summary()
        rounds = len(chunk_ms)
        check(rep["blocking_polls"] == rounds
              == rep["device_iters"] // SERVE_CHUNK,
              f"phase 5 {key.describe()}: {rep['blocking_polls']} blocking "
              f"polls over {rounds} rounds")
        check(served["traces"][key] == 5,
              f"phase 5 {key.describe()}: stepwise_traces "
              f"{served['traces'][key]}, want 5")
        total_iters += rep["device_iters"]
        lat = np.asarray([t.latency_s for t in tickets])
        print(f"phase 5 {key.describe()}: {rounds} rounds, "
              f"{rep['refills']} refills, {rep['completed']} served, "
              f"blocking polls {rep['blocking_polls']} (one a round), "
              f"device iters {rep['device_iters']} x {rep['slots']} lanes, "
              f"wasted_iter_frac {rep['wasted_iter_frac']} (whole-batch "
              f"run_batch of the same requests {whole_wasted}), device NFE "
              f"{rep['device_nfe']}, {rep['host_fetch_bytes'] / rounds} "
              f"B/round, {rep['gather_launches']} gathers; ticket latency "
              f"p50 {np.percentile(lat, 50)} s p95 {np.percentile(lat, 95)}"
              f" s; chunk device ms {chunk_ms}; stepwise_step host ms "
              f"{host_ms} (host share of its chunk "
              f"{sum(host_ms) / sum(chunk_ms)}); device idle at the "
              f"{len(wait_ms)} poll waits {sum(wait_ms)} ms; stepwise_traces "
              f"{served['traces'][key]}")
    log = served["log"]
    span_ms = log[0][0].elapsed_time(log[-1][1])
    busy_ms = sum(a.elapsed_time(b) for a, b, _ in log)
    wait_ms = sum(sum(tm.summary()[2]) for tm in served["timers"].values())
    print(f"phase 5 drain: {len(served['tickets'])} tickets resolved, none "
          f"failed, in {served['drain_s']} s; loop stats "
          f"{served['loop_stats']}; device from the first chunk's start to "
          f"the last chunk's end {span_ms} ms, in chunks {busy_ms} ms: "
          f"device idle share {1 - busy_ms / span_ms} (outside the chunks: "
          f"idle, or the small harvest and refill kernels); at the poll "
          f"waits {wait_ms} ms "
          f"(share {wait_ms / span_ms}); K3 launches in the drain "
          f"{served['launches']}")
    check(served["launches"] == {"taa_gram": 0, "taa_apply": 0,
                                 "taa_round": total_iters},
          f"phase 5 launches {served['launches']} != {total_iters} device "
          f"iterations")
    return dict(idle_share=1 - busy_ms / span_ms,
                taa_round_launches=served["launches"]["taa_round"])


# --- phase 6: train -> checkpoint -> serve at full DiT-XL width -------------

#: phase 6's train flags (``repro_torch.launch.train``) beside ``--steps``
#: and ``--ckpt-dir``: one save per run, the final one
TRAIN_FLAGS = ["--arch", "dit-xl", "--batch", "16", "--ckpt-every", "1000",
               "--log-every", "1"]
#: run B's losses against run C's at the same steps: the same state and
#: batches, but the backward of the y_embed gather accumulates with
#: atomics, so the two runs need not agree bit for bit
LOSS_RTOL = 1e-5
#: the serve flags phase 6 restores the checkpoint with (``serve.py``)
SERVE_FLAGS = ["--steps-T", "25", "--requests", "2", "--batch-size", "2"]
#: DiT-XL's parameters at latent 16 and 1000 classes (``dit_defs``)
DIT_XL_PARAMS = 822_962_304


def kernel_modules():
    from repro_torch.kernels import (flash_attention, flash_decode,
                                     rglru_scan, ssd_scan, taa_update)
    return (taa_update, flash_attention, flash_decode, ssd_scan, rglru_scan)


def reset_all_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in kernel_modules():
        out.update(mod.launches)
    return out


class CkptTimes:
    """Wall seconds of the checkpoint calls the drivers make: each
    ``save_pytree`` (the background thread's serialization and write),
    ``CheckpointManager.save`` (the host copy and, with ``blocking``, the
    wait for the write) and ``load_pytree`` (a restore's read and
    placement on the card)."""

    NAMES = ("save_pytree", "load_pytree")

    def __init__(self):
        from repro_torch.ckpt import checkpoint

        self.mod = checkpoint
        self.real = {name: getattr(checkpoint, name) for name in self.NAMES}
        self.real["save"] = checkpoint.CheckpointManager.save
        self.log = []
        for name in self.NAMES:
            setattr(checkpoint, name, self._timed(name, self.real[name]))
        checkpoint.CheckpointManager.save = self._timed("save",
                                                        self.real["save"])

    def _timed(self, name, fn):
        def call(*args, **kw):
            t0 = time.monotonic()
            out = fn(*args, **kw)
            self.log.append((name, time.monotonic() - t0))
            return out
        return call

    def take(self) -> dict:
        out = {}
        for name, s in self.log:
            out.setdefault(name, []).append(s)
        self.log = []
        return out

    def restore(self) -> None:
        for name in self.NAMES:
            setattr(self.mod, name, self.real[name])
        self.mod.CheckpointManager.save = self.real["save"]


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_run(label, argv, times):
    """One run of the train driver (``train.run``, whose losses
    ``train.main`` returns), every launch count set to 0 just before and
    read just after: the training path launches no kernel of the port."""
    from repro_torch.launch import train

    reset_all_launches()
    t0 = time.monotonic()
    res = train.run(argv)
    wall = time.monotonic() - t0
    launches = all_launches()
    print(f"phase 6 run {label} ({' '.join(argv)}): resumed at step "
          f"{res.start_step}, losses {res.losses}, run {wall} s, "
          f"checkpoint calls (s) {times.take()}, kernel launches {launches}")
    for st in res.step_ms:
        print(f"phase 6 run {label} step {st}")
    check(not any(launches.values()),
          f"phase 6 run {label}: kernel launches {launches} in training")
    check(all(math.isfinite(x) for x in res.losses),
          f"phase 6 run {label}: non-finite loss {res.losses}")
    return res


def serve_run(label, ckpt_dir, flags):
    """``serve.main --ckpt`` once, every launch count set to 0 just before
    and read just after; the engine's results kept for the checks."""
    from repro_torch.launch import serve

    captured = []
    real_make = serve.make_engine

    def make_engine(*args, **kw):
        engine = real_make(*args, **kw)
        run_batch = engine.run_batch

        def recorded(*a, **k):
            results = run_batch(*a, **k)
            captured.append((engine, results))
            return results
        engine.run_batch = recorded
        return engine

    serve.make_engine = make_engine
    try:
        reset_all_launches()
        t0 = time.monotonic()
        outs, _ = serve.main(["--ckpt", str(ckpt_dir), *flags])
        wall = time.monotonic() - t0
        launches = all_launches()
    finally:
        serve.make_engine = real_make
    [(engine, results)] = captured
    d = engine.last_dispatches[0]
    print(f"phase 6 serve {label}: " + "; ".join(
        f"label={r.request.label} iters={r.iters} nfe={r.nfe} "
        f"converged={r.converged}" for r in results)
        + f"; dispatch wall {d['wall_s']} s over {d['device_iters']} device "
          f"iterations; kernel launches {launches}; serve.main {wall} s")
    return dict(outs=outs, results=results, device_iters=d["device_iters"],
                launches=launches)


def step_summary(runs) -> dict:
    """Median train-step ms over the runs' steps after each run's first
    (which pays the process's one-time costs)."""
    steady = [st for res in runs for st in res.step_ms[1:]]
    return {k: statistics.median(st[k] for st in steady)
            for k in ("wall_ms", "fwd_bwd_ms", "update_ms")}


def train_checkpoint_serve(ckpt_dir: Path):
    """Phase 6: runs A (2 steps, saves step 2), B (resumes at step 2, runs
    steps 2-3, saves step 4) and C (4 steps, no checkpoint) of the train
    driver at DiT-XL's full width; the step-4 params read back against B's
    in memory; then ``serve.main --ckpt`` with ParaTAA (fused: K3) and with
    sequential DDIM.  The checkpoint directory is deleted at the end."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.tree import leaves

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    usage = shutil.disk_usage(ckpt_dir)
    print(f"phase 6 checkpoint dir {ckpt_dir}: disk total {usage.total} B, "
          f"used {usage.used} B, free {usage.free} B before the first save")
    times = CkptTimes()
    try:
        torch.cuda.reset_peak_memory_stats()
        ck = ["--ckpt-dir", str(ckpt_dir)]
        a = train_run("A", TRAIN_FLAGS + ["--steps", "2"] + ck, times)
        check(len(a.losses) == 2, f"phase 6 run A: {len(a.losses)} losses")
        del a
        free_card()
        b = train_run("B", TRAIN_FLAGS + ["--steps", "4"] + ck, times)
        check(b.start_step == 2 and len(b.losses) == 2,
              f"phase 6 run B: resumed at step {b.start_step} with "
              f"{len(b.losses)} losses, want 2 and 2")
        params_b = b.state["params"]
        b.state = None           # the optimizer state goes
        free_card()
        c = train_run("C", TRAIN_FLAGS + ["--steps", "4"], times)
        check(len(c.losses) == 4, f"phase 6 run C: {len(c.losses)} losses")
        train_peak = torch.cuda.max_memory_allocated()
        c.state = None
        free_card()
        loss_err = max(abs(x - y) / abs(y)
                       for x, y in zip(b.losses, c.losses[2:]))
        print(f"phase 6 losses: B (steps 2-3) {b.losses}, C (steps 0-3) "
              f"{c.losses}; B against C's steps 2-3 rel err {loss_err} "
              f"(bound {LOSS_RTOL})")
        check(loss_err < LOSS_RTOL,
              f"phase 6 B's losses off C's by {loss_err}")
        steps = sorted(p.name for p in ckpt_dir.glob("step_*"))
        check(steps == ["step_00000002", "step_00000004"],
              f"phase 6 checkpoints {steps}")
        step_dir = ckpt_dir / "step_00000004"
        nbytes = sum(p.stat().st_size for p in step_dir.iterdir())
        step, tree = CheckpointManager(ckpt_dir).restore(
            {"step": 0, "params": params_b})
        read_s = times.take()["load_pytree"]
        same = all(torch.equal(x, y) for x, y in zip(
            leaves(tree["params"]), leaves(params_b)))
        n_params = sum(x.numel() for x in leaves(tree["params"]))
        print(f"phase 6 checkpoint step {step}: {nbytes} B on disk "
              f"(params + AdamW master, mu, nu; {n_params} parameters); "
              f"params read back in {read_s} s, equal to run B's in memory "
              f"(torch.equal, every leaf): {same}")
        check(step == 4 and same, "phase 6 restored params != run B's")
        check(n_params == DIT_XL_PARAMS, f"phase 6: {n_params} parameters")
        summary = step_summary([b, c])
        print(f"phase 6 train step, median of B's and C's steps after "
              f"each run's first: wall {summary['wall_ms']} ms, device "
              f"forward+backward {summary['fwd_bwd_ms']} ms, update "
              f"{summary['update_ms']} ms; peak memory allocated in "
              f"training {train_peak} B")
        del tree, params_b
        free_card()
        torch.cuda.reset_peak_memory_stats()
        served = {}
        for label, extra in (("taa", ["--solver", "taa", "--fuse-round"]),
                             ("seq", ["--solver", "seq"])):
            served[label] = serve_run(label, ckpt_dir, SERVE_FLAGS + extra)
        serve_peak = torch.cuda.max_memory_allocated()
        print(f"phase 6 serve checkpoint calls (s) {times.take()}; peak "
              f"memory allocated in serving {serve_peak} B")
    finally:
        times.restore()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    taa, seq = served["taa"], served["seq"]
    err = float(np.max(np.abs(taa["outs"] - seq["outs"]))
                / np.max(np.abs(seq["outs"])))
    print(f"phase 6 served from the checkpoint: ParaTAA x0 against "
          f"sequential rel err {err} (bound 2e-2), iters "
          f"{[r.iters for r in taa['results']]} of T=25")
    check(taa["outs"].shape == seq["outs"].shape == (2, 16, 16)
          and np.all(np.isfinite(taa["outs"])), "phase 6 x0 shape/finite")
    check(err < 2e-2, f"phase 6 ParaTAA x0 off sequential by {err}")
    check(all(r.converged for r in taa["results"]),
          "phase 6: a ParaTAA request did not converge")
    want = {name: 0 for name in all_launches()}
    check(seq["launches"] == want,
          f"phase 6 seq launches {seq['launches']}")
    want["taa_round"] = taa["device_iters"]
    check(taa["launches"] == want,
          f"phase 6 taa launches {taa['launches']} != K3 once per "
          f"iteration ({taa['device_iters']})")


# --- phase 4: the model kernels through kernels.ops at model widths ----------


def model_cases():
    """The phase-4 calls, at the full widths of models this repo configures;
    inputs on the card from a numpy seed, at the JAX tests' magnitudes
    (tests/test_kernels.py).  Each case: the kernel it launches, the width's
    source, the entry-point call, its plain version, one PyTorch library
    call computing the same function (or None), the tolerance and whether
    the error is absolute or relative, and its bytes and operations."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (flash_attention, flash_decode, ops, ref,
                                     rglru_scan, ssd_scan)

    rng = np.random.default_rng(SEED + 4)
    bf16, f32 = torch.bfloat16, torch.float32

    def t(*shape, scale=1.0, dtype=f32):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).cuda().to(dtype)

    cases = []

    def attention(label, source, B, H, S, T, D, dtype, causal, window):
        q, k, v = t(B, H, S, D, dtype=dtype), t(B, H, T, D, dtype=dtype), \
            t(B, H, T, D, dtype=dtype)
        qp = torch.arange(S)[:, None] + (T - S)
        kp = torch.arange(T)[None, :]
        live = torch.ones(S, T, dtype=torch.bool)
        if causal:
            live &= kp <= qp
        if window:
            live &= kp > qp - window
        mask = live.cuda()
        n_live = int(live.sum())
        lib = (lambda: F.scaled_dot_product_attention(q, k, v)) \
            if not causal and not window else \
            (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)) \
            if not window else \
            (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        e = q.element_size()
        path = flash_attention.attention_path(dtype, D)
        tc = path == "tensor_cores"
        # the TF32 kernel on float32: three TF32 products a product (the
        # 3xTF32 split), beside the float32 bound of the CUDA-core kernel it
        # replaced
        tf32 = {} if tc or dtype != f32 else dict(
            f32_ops=4 * D * B * H * n_live, f32_what="CUDA-core float32")
        cases.append(dict(
            kernel="flash_attention_tc" if tc else "flash_attention",
            path=path, expect={"flash_attention": 1,
                               "flash_attention_tc": int(tc)},
            label=label, source=source,
            run=lambda: ops.attention(q, k, v, causal=causal, window=window),
            plain=lambda: ref.attention_ref(q, k, v, causal=causal,
                                            window=window),
            library=lib, tol=TOL[str(dtype).split(".")[-1]], rel=False,
            nbytes=(2 * B * H * S * D + 2 * B * H * T * D) * e,
            ops=4 * D * B * H * n_live * (3 if tf32 else 1),
            matmul_dtype="tf32" if tf32 else dtype, **tf32))

    attention("dit-xl eps batch, non-causal, f32 (B=50 H=16 S=T=256 D=72)",
              "configs/dit_xl.py", 50, 16, 256, 256, 72, f32, False, 0)
    attention("qwen3-0.6b causal prefill, bf16 (B=1 H=16 S=T=4096 D=128)",
              "configs/qwen3_0_6b.py", 1, 16, 4096, 4096, 128, bf16, True, 0)
    attention("recurrentgemma-2b causal window 2048, bf16 (B=1 H=10 S=T=4096 "
              "D=256)", "configs/recurrentgemma_2b.py", 1, 10, 4096, 4096,
              256, bf16, True, 2048)

    def decode(label, source, B, H, KV, T, D, dtype, int8):
        q = t(B, H, D, dtype=dtype)
        lengths = torch.from_numpy(rng.integers(1, T + 1, size=B)).to(
            torch.int32).cuda()
        lengths[0] = T
        valid = torch.arange(T, device="cuda")[None] < lengths[:, None]
        live = int(lengths.sum())
        if int8:
            kq, ks = ref.quantize_kv(t(B, T, KV, D))
            vq, vs = ref.quantize_kv(t(B, T, KV, D))
            run = lambda: flash_decode.flash_decode(q, kq, vq, lengths,
                                                    k_scale=ks, v_scale=vs)
            plain = lambda: ref.decode_int8_ref(q, kq, vq, lengths, ks, vs)
            lib, tol = None, 2e-5          # the int8 oracle's bound
            cache_bytes = live * KV * (2 * D + 2 * 4)
        else:
            k, v = t(B, T, KV, D, dtype=dtype), t(B, T, KV, D, dtype=dtype)
            run = lambda: ops.decode_attention(q, k, v, lengths)
            plain = lambda: ref.decode_ref(q, k, v, lengths)
            lib = lambda: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=valid[:, None, None, :], enable_gqa=True)
            tol = TOL[str(dtype).split(".")[-1]]
            cache_bytes = live * KV * 2 * D * k.element_size()
        splits, chunk = flash_decode.split_plan(B, KV, T, D)
        cases.append(dict(
            kernel="flash_decode", splits=splits, chunk=chunk,
            path=f"{splits} splits of {chunk} keys",
            expect={"flash_decode": 1,
                    "flash_decode_combine": int(splits > 1)},
            label=label, source=source, run=run,
            plain=plain, library=lib, tol=tol, rel=False,
            nbytes=cache_bytes + 2 * B * H * D * q.element_size() + B * 8,
            ops=4 * D * H * live, matmul_dtype=dtype))

    decode("qwen3-0.6b decode, bf16, ragged lengths (B=8 H=16 KV=8 T=4096 "
           "D=128)", "configs/qwen3_0_6b.py", 8, 16, 8, 4096, 128, bf16, False)
    # q in float32 so that the JAX int8 test's 2e-5 bound applies
    decode("qwen3-0.6b decode, int8 cache + scales, f32 q (B=8 H=16 KV=8 "
           "T=4096 D=128)", "configs/qwen3_0_6b.py", 8, 16, 8, 4096, 128, f32,
           True)
    decode("recurrentgemma-2b MQA decode, bf16 (B=8 H=10 KV=1 T=2048 D=256)",
           "configs/recurrentgemma_2b.py", 8, 10, 1, 2048, 256, bf16, False)

    b, s, h, p, n = 2, 2048, 64, 64, 128
    x = t(b, s, h, p, scale=0.5)
    dt = F.softplus(t(b, s, h))
    A = -torch.exp(t(h, scale=0.3))
    Bm, Cm = t(b, s, n, scale=0.5), t(b, s, n, scale=0.5)
    plan = ssd_scan.chunk_plan(s)
    q, nc = plan["chunk"], plan["chunks"]
    cases.append(dict(
        kernel="ssd_scan", expect=plan["launches"],
        path=f"chunked, internal chunk {q} ({nc} chunks), launches per call "
             f"{plan['launches']}",
        source="configs/mamba2_1_3b.py",
        label=f"mamba2-1.3b SSD, f32, chunk 256 (b={b} s={s} h={h} p={p} "
              f"n={n})",
        run=lambda: ops.ssd(x, dt, A, Bm, Cm, chunk=256),
        plain=lambda: ref.ssd_ref(x, dt, A, Bm, Cm), library=None,
        tol=1e-4, rel=True,
        nbytes=4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                    + b * h * p * n),
        # the chunked form's products: C B^T once per (b, chunk), the
        # causal W x, the local state and the inter-chunk output per (b, h,
        # chunk); three TF32 products each (the 3xTF32 split)
        ops=3 * (b * nc * 2 * q * q * n
                 + b * h * nc * (q * (q + 1) * p + 2 * q * p * n)
                 + b * h * (nc - 1) * 2 * q * p * n),
        # the earlier per-step recurrence's float32 operations
        f32_ops=5 * b * s * h * p * n, f32_what="per-step float32",
        matmul_dtype="tf32"))

    for dtype in (f32, bf16):
        B, S, C = 2, 4096, 2560
        a = torch.sigmoid(t(B, S, C)).to(dtype)
        bb = t(B, S, C, scale=0.3, dtype=dtype)
        tp = rglru_scan.tile_plan(B, S, C, a.element_size())
        case = dict(
            kernel="rglru_scan", expect={"rglru_scan": 1},
            path=f"{tp['tiles']} tiles of {tp['steps']} steps x "
                 f"{tp['channels']} channels ({tp['segments']} segments x "
                 f"{tp['chains']} chains), one read of a and b",
            source="configs/recurrentgemma_2b.py",
            label=f"recurrentgemma-2b RG-LRU, {str(dtype).split('.')[-1]} "
                  f"(B={B} S={S} C={C})",
            plain=(lambda a=a, bb=bb: ref.rglru_ref(a, bb)), library=None,
            tol=1e-4 if dtype == f32 else 5e-2, rel=False,
            nbytes=3 * B * S * C * a.element_size(), ops=2 * B * S * C,
            matmul_dtype=None)

        def run(a=a, bb=bb, case=case):
            out = ops.rglru(a, bb)
            case["grid"] = dict(rglru_scan.last_grid)
            return out
        case["run"] = run
        cases.append(case)
    return cases


def case_bound(case):
    """Least time (ms) for a case: its bytes over HBM bandwidth, and its
    operations over the card's peak for the unit that runs them — the bf16
    tensor-core rate for attention's products on bf16 inputs, the TF32
    tensor-core rate for float32 attention's and the SSD scan's products
    (three a product in 3xTF32), the float32 rate of the CUDA cores
    otherwise (the RG-LRU scan); the larger, and which bounds it.  For the
    float32 attention and the SSD scan also the float32 bound of their
    earlier CUDA-core designs, which the tensor-core ones no longer obey
    (``f32_bound_ms``)."""
    import torch

    t_bytes = case["nbytes"] / HBM_BYTES_PER_S * 1e3
    peak = {torch.bfloat16: BF16_TC_FLOPS_PER_S,
            "tf32": TF32_TC_FLOPS_PER_S}.get(case["matmul_dtype"],
                                             F32_FLOPS_PER_S)
    t_ops = case["ops"] / peak * 1e3
    out = dict(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    if "f32_ops" in case:
        out["f32_bound_ms"] = max(
            t_bytes, case["f32_ops"] / F32_FLOPS_PER_S * 1e3)
    return out


def drive_model_kernels(cases):
    """Phase 4's path: every case once through its entry point, with every
    launch count set to 0 just before and read just after."""
    import torch

    from repro_torch.kernels import (flash_attention, flash_decode, rglru_scan,
                                     ssd_scan)

    mods = (flash_attention, flash_decode, ssd_scan, rglru_scan)
    for mod in mods:
        mod.reset_launches()
    outs = [case["run"]() for case in cases]
    torch.cuda.synchronize()
    launches = {}
    for mod in mods:
        launches.update(mod.launches)
    # what each call should launch: the tensor-core kernel for the bf16
    # attention cases (counted under both attention keys), the split pass
    # and, with more than one split, the combine for each decode case
    calls = {name: sum(c["expect"].get(name, 0) for c in cases)
             for name in launches}
    for case in cases:
        if "path" in case:
            grid = f"; cooperative grid {case['grid']}" if "grid" in case \
                else ""
            print(f"{case['label']}: path {case['path']}{grid}")
    print(f"model kernels: launches {launches} for calls {calls}")
    check(launches == calls, f"launches {launches} != calls {calls}")
    return outs, launches


def check_model_kernels(cases, outs):
    """Each output against its plain version on the same inputs on the card.
    Returns the largest absolute error per kernel."""
    import torch

    worst = {}
    for case, out in zip(cases, outs):
        want = case["plain"]()
        errs = []
        for o, w in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            check(o.shape == w.shape and bool(torch.isfinite(o).all()),
                  f"{case['label']}: shape {tuple(o.shape)} or non-finite")
            err = float((o.float() - w.float()).abs().max())
            scale = float(w.float().abs().max()) if case["rel"] else 1.0
            errs.append((err, err / scale))
        err_abs = max(e[0] for e in errs)
        err = max(e[1] for e in errs)
        case["max_abs_err"] = err_abs
        print(f"{case['label']}: {'rel' if case['rel'] else 'max abs'} err "
              f"{err} (bound {case['tol']}), max abs {err_abs}; two runs bit "
              f"for bit")
        check(err < case["tol"], f"{case['label']}: {err} >= {case['tol']}")
        again = case["run"]()
        for o, a in zip(out if isinstance(out, tuple) else (out,),
                        again if isinstance(again, tuple) else (again,)):
            check(torch.equal(o, a), f"{case['label']}: two runs differ")
        del again
        worst[case["kernel"]] = max(worst.get(case["kernel"], 0.0), err_abs)
        del want
    return worst


def timed(fn):
    """(CUDA-event wall ms, profiler device ms) per call, with fewer
    repetitions for calls that take long (the plain scans run thousands of
    small launches)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    once = start.elapsed_time(stop)
    if once > 20.0:
        return cuda_ms(fn, warmup=0, samples=3, reps=1), device_ms(fn, reps=2)
    if once > 2.0:
        return cuda_ms(fn, warmup=1, samples=5, reps=2), device_ms(fn, reps=10)
    return cuda_ms(fn), device_ms(fn)


def time_model_kernels(cases):
    for case in cases:
        wall, dev = zip(*(timed(f) if f else (None, None) for f in (
            case["run"], case["plain"], case["library"])))
        # achieved rates over the kernel's device time (its wall time where
        # the profiler saw no device work)
        t = dev[0] if dev[0] else wall[0]
        case.update(case_bound(case), ms=wall[0], plain_ms=wall[1],
                    library_ms=wall[2], device_ms=dev[0],
                    plain_device_ms=dev[1], library_device_ms=dev[2],
                    achieved_tflops=case["ops"] / t / 1e9,
                    achieved_tb_s=case["nbytes"] / t / 1e9)
        step = f"; the {case['f32_what']} bound {case['f32_bound_ms']} ms " \
            f"({case['f32_ops']} flop)" if "f32_bound_ms" in case else ""
        print(f"time {case['label']}: kernel {wall[0]} ms (device {dev[0]} "
              f"ms), plain {wall[1]} ms (device {dev[1]} ms), library "
              f"{wall[2]} ms (device {dev[2]} ms), bound {case['bound_ms']} ms"
              f" by {case['bound_by']} ({case['nbytes']} B, {case['ops']} "
              f"flop){step}; achieved {case['achieved_tflops']} TFLOP/s, "
              f"{case['achieved_tb_s']} TB/s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")

    t0 = time.monotonic()
    libs = build.build_all()
    print(f"build: {len(libs)} libraries, one nvcc each in parallel, in "
          f"{time.monotonic() - t0} s")
    for lib in libs.values():
        print(f"  {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")
    for name in ("flash_attention", "flash_attention_tc", "flash_decode",
                 "taa_round", "ssd_scan", "rglru_scan"):
        print(f"ptxas {name} ({SOURCES[name]}): "
              f"{ptxas_summary(libs[ROOT / SOURCES[name]])}")
    check_sass(libs[ROOT / SOURCES["flash_attention_tc"]],
               "flash_attention_tc", ("HGMMA", "UTMALDG"))
    check_sass(libs[ROOT / SOURCES["flash_attention"]], "flash_attention",
               ("HMMA",))
    check_sass(libs[ROOT / SOURCES["ssd_scan"]], "ssd_scan", ("HMMA",))

    t1 = time.monotonic()
    errs = check_kernels()
    times, bnd = time_kernels()
    t2 = time.monotonic()
    runs, params, cfg = main_path()
    check_main_path(runs)
    t3 = time.monotonic()
    cases = model_cases()
    print(f"phase 4 inputs made in {time.monotonic() - t3} s")
    outs, model_launches = drive_model_kernels(cases)
    errs.update(check_model_kernels(cases, outs))
    del outs
    time_model_kernels(cases)
    t4 = time.monotonic()
    cuda = torch.device("cuda")
    served = serving_path(params, cfg, cuda)
    serving = check_serving(served, params, cfg, cuda)
    t5 = time.monotonic()

    launches = {"taa_gram": runs["taa staged"]["launches"]["taa_gram"],
                "taa_apply": runs["taa staged"]["launches"]["taa_apply"],
                "taa_round": runs["taa fused"]["launches"]["taa_round"],
                **model_launches}
    rows = []
    library_calls = {
        "taa_gram": "torch.einsum of the (m+1)-stream stack [dF; R] with "
                    "itself (G and u together, and R.R); the stack made "
                    "outside the timed call",
        "taa_apply": None, "taa_round": None}
    for name in ("taa_gram", "taa_apply", "taa_round"):
        t = times[name]
        rows.append(dict(library_call=library_calls[name],
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=bnd[name]["bound_ms"], bound_by=bnd[name]["bound_by"],
            library_ms=t["library_ms"], device_ms=t["device_ms"],
            plain_device_ms=t["plain_device_ms"],
            library_device_ms=t["library_device_ms"],
            **({"stepwise_launches": serving["taa_round_launches"]}
               if name == "taa_round" else {})))
    keys = ("label", "path", "ms", "device_ms", "plain_ms", "plain_device_ms",
            "library_ms", "library_device_ms", "bound_ms", "bound_by",
            "f32_bound_ms", "nbytes", "ops", "achieved_tflops",
            "achieved_tb_s", "max_abs_err", "tol")
    # "flash_attention" counts every attention launch, "flash_attention_tc"
    # those of the tensor-core kernel; "flash_decode" the split passes, with
    # the combine passes beside them; "ssd_scan" the chunk passes, with the
    # state passes beside them
    for name in ("flash_attention", "flash_attention_tc", "flash_decode",
                 "ssd_scan", "rglru_scan"):
        mine = [c for c in cases if c["kernel"] == name]
        c = mine[0]   # the row's numbers are its first case's; all in "cases"
        extra = {"combine_launches": launches["flash_decode_combine"]} \
            if name == "flash_decode" else \
            {"state_pass_launches": launches["ssd_state_pass"]} \
            if name == "ssd_scan" else {}
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name], **extra,
            max_abs_err=errs[name], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], device_ms=c["device_ms"],
            plain_device_ms=c["plain_device_ms"],
            library_device_ms=c["library_device_ms"],
            achieved_tflops=c["achieved_tflops"],
            achieved_tb_s=c["achieved_tb_s"], case=c["label"],
            cases=[{k: m.get(k) for k in keys} for m in mine]))
    # phase 6 on a card freed of the earlier phases' params, engines and
    # inputs
    del runs, params, served, cases, mine, c
    free_card()
    train_checkpoint_serve(ROOT / "build" / "chip_smoke_ckpt")
    print(f"phase seconds: build {t1 - t0}, taa kernels {t2 - t1}, DiT-XL "
          f"serving {t3 - t2}, model kernels {t4 - t3}, DiT-XL stepwise "
          f"serving {t5 - t4}, DiT-XL train-checkpoint-serve "
          f"{time.monotonic() - t5}")
    # the card again, so that the end of a long log still names it
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
