#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), end to end.

    python3 chip_smoke.py

Phases (each prints its lines; any failed check raises, so the exit code
is not 0):

1. device and build: the card's name and power limit from nvidia-smi, then
   every kernel library compiled from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, all started together; build seconds and the compiler's
   register report, summed for the two redesigned kernels); the tensor-core
   attention kernel's SASS must hold HGMMA and UTMALDG instructions (where
   cuobjdump is found);
2. each TAA-update kernel against its plain PyTorch version on the card, at the main
   path's shapes (B=2 lanes, m=3, T=25, D=4096 = 256 tokens x latent 16),
   float32 and bfloat16, a ragged D=4000, every round mode with a nonzero
   guard; then kernel / plain / library times (CUDA events, median of 25
   windows; and device time from torch.profiler) beside the least time
   the card could take;
3. the main path at full DiT-XL width (28 layers, d 1152, 16 x 72 heads,
   d_ff 4608, 256 tokens), random weights from a numpy seed, float32 with
   TF32 off: 2 requests served in one batch through the serving entry
   points with ParaTAA staged, ParaTAA fused, and sequential DDIM (T=25).
   Checks: every ParaTAA request converged, ParaTAA's x0 within 2e-2
   relative of sequential, staged and fused within 1e-4 relative, and each
   kernel's launches during its run equal to the device iterations;
4. the model kernels (flash attention, GQA flash decode with a bf16 and an
   int8 cache, Mamba2 SSD scan, RG-LRU scan) driven once each through
   ``repro_torch.kernels.ops`` (``flash_decode`` for int8) at the full
   widths of DiT-XL, qwen3-0.6b, recurrentgemma-2b and mamba2-1.3b, every
   launch count set to 0 just before and checked equal to what the calls
   should launch just after (the tensor-core attention kernel for bf16, the
   CUDA-core one for float32; the decode's split pass, and its combine pass
   where the cache is split); each case's path and split count printed;
   each output against its plain version on the same inputs (the JAX
   tests' bounds); then kernel / plain / library times and achieved
   TFLOP/s and TB/s beside the least time the card could take.

Then one JSON line of per-kernel numbers, and last the line
``{"ok": true, "device": {...}}``.  Without CUDA, or run from a directory
without the repository's ``src/``, it fails before printing any result.
"""
from __future__ import annotations

import json
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


def check_sass(lib) -> None:
    """The tensor-core kernel is Hopper's: its SASS holds warpgroup MMAs
    (HGMMA) and TMA loads (UTMALDG).  Checked where cuobjdump is found."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        print("SASS of flash_attention_tc: not checked (no cuobjdump)")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: sum(op in line for line in sass.splitlines())
              for op in ("HGMMA", "UTMALDG")}
    print(f"SASS of flash_attention_tc: {counts} instructions")
    check(all(n > 0 for n in counts.values()),
          f"flash_attention_tc SASS lacks HGMMA or UTMALDG: {counts}")


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
            out = k.taa_apply(a["x"], a["R"], a["dX"], a["dF"], a["gamma"],
                              a["mask"])
            want = ref.taa_apply_ref(a["x"], a["R"], a["dX"], a["dF"],
                                     a["gamma"], a["mask"])
            err_a = float((out.float() - want.float()).abs().max())
            errs_r = []
            for mode in ("taa", "aa", "aa+"):
                out = k.taa_round(a["x"], a["R"], a["dX"], a["dF"],
                                  a["mask"], a["guard"], mode=mode, lam=1e-6)
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
            if dtype == torch.float32 and D == 4096:
                worst.update(taa_gram=err_g, taa_apply=err_a,
                             taa_round=max(errs_r))
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
    calls = {
        "taa_gram": (lambda: k.taa_gram(dF, R, mask),
                     lambda: ref.taa_gram_ref(dF, R, mask),
                     # one PyTorch call for K1's Gram blocks (G only; every
                     # row is active, so the mask is the identity)
                     lambda: torch.einsum("bmtd,bntd->btmn", dF, dF)),
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
    return runs


def serve_once(label, params, cfg, coeffs, spec, requests):
    """One run of the serving path through ``SamplingEngine.run_batch``,
    every launch count set to 0 just before it and read just after."""
    import torch

    from repro_torch.kernels import taa_update
    from repro_torch.launch import serve
    from repro_torch.sampling import SamplingEngine

    timed = TimedEps(serve.make_eps_apply(cfg))
    engine = SamplingEngine(timed, params, coeffs, spec,
                            sample_shape=(NUM_TOKENS, cfg.latent_dim),
                            device=torch.device("cuda"))
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
          f"kernel launches {launches}")
    return dict(results=results, device_iters=d["device_iters"],
                launches=launches)


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

    from repro_torch.kernels import flash_attention, flash_decode, ops, ref

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
        lib = (lambda: F.scaled_dot_product_attention(q, k, v)) \
            if not causal and not window else \
            (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)) \
            if not window else \
            (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        e = q.element_size()
        path = flash_attention.attention_path(dtype, D)
        tc = path == "tensor_cores"
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
            ops=4 * D * B * H * int(live.sum()), matmul_dtype=dtype))

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
    cases.append(dict(
        kernel="ssd_scan", expect={"ssd_scan": 1},
        source="configs/mamba2_1_3b.py",
        label=f"mamba2-1.3b SSD, f32, chunk 256 (b={b} s={s} h={h} p={p} "
              f"n={n})",
        run=lambda: ops.ssd(x, dt, A, Bm, Cm, chunk=256),
        plain=lambda: ref.ssd_ref(x, dt, A, Bm, Cm), library=None,
        tol=1e-4, rel=True,
        nbytes=4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                    + b * h * p * n),
        ops=5 * b * s * h * p * n, matmul_dtype=None))

    for dtype in (f32, bf16):
        B, S, C = 2, 4096, 2560
        a = torch.sigmoid(t(B, S, C)).to(dtype)
        bb = t(B, S, C, scale=0.3, dtype=dtype)
        cases.append(dict(
            kernel="rglru_scan", expect={"rglru_scan": 1},
            source="configs/recurrentgemma_2b.py",
            label=f"recurrentgemma-2b RG-LRU, {str(dtype).split('.')[-1]} "
                  f"(B={B} S={S} C={C})",
            run=(lambda a=a, bb=bb: ops.rglru(a, bb)),
            plain=(lambda a=a, bb=bb: ref.rglru_ref(a, bb)), library=None,
            tol=1e-4 if dtype == f32 else 5e-2, rel=False,
            nbytes=3 * B * S * C * a.element_size(), ops=2 * B * S * C,
            matmul_dtype=None))
    return cases


def case_bound(case):
    """Least time (ms) for a case: its bytes over HBM bandwidth, and its
    operations over the card's peak for their type — the bf16 tensor-core
    rate for attention's products on bf16 inputs, the float32 rate of the
    CUDA cores otherwise (float32 products, and the scans, which are no
    matrix products); the larger, and which bounds it."""
    import torch

    t_bytes = case["nbytes"] / HBM_BYTES_PER_S * 1e3
    peak = BF16_TC_FLOPS_PER_S if case["matmul_dtype"] == torch.bfloat16 \
        else F32_FLOPS_PER_S
    t_ops = case["ops"] / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
            print(f"{case['label']}: path {case['path']}")
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
              f"{err} (bound {case['tol']}), max abs {err_abs}")
        check(err < case["tol"], f"{case['label']}: {err} >= {case['tol']}")
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
        print(f"time {case['label']}: kernel {wall[0]} ms (device {dev[0]} "
              f"ms), plain {wall[1]} ms (device {dev[1]} ms), library "
              f"{wall[2]} ms (device {dev[2]} ms), bound {case['bound_ms']} ms"
              f" by {case['bound_by']} ({case['nbytes']} B, {case['ops']} "
              f"flop); achieved {case['achieved_tflops']} TFLOP/s, "
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
    for name in ("flash_attention_tc", "flash_decode"):
        print(f"ptxas {name}: {ptxas_summary(libs[ROOT / SOURCES[name]])}")
    check_sass(libs[ROOT / SOURCES["flash_attention_tc"]])

    t1 = time.monotonic()
    errs = check_kernels()
    times, bnd = time_kernels()
    t2 = time.monotonic()
    runs = main_path()
    check_main_path(runs)
    t3 = time.monotonic()
    cases = model_cases()
    print(f"phase 4 inputs made in {time.monotonic() - t3} s")
    outs, model_launches = drive_model_kernels(cases)
    errs.update(check_model_kernels(cases, outs))
    del outs
    time_model_kernels(cases)
    print(f"phase seconds: build {t1 - t0}, taa kernels {t2 - t1}, DiT-XL "
          f"serving {t3 - t2}, model kernels {time.monotonic() - t3}")

    launches = {"taa_gram": runs["taa staged"]["launches"]["taa_gram"],
                "taa_apply": runs["taa staged"]["launches"]["taa_apply"],
                "taa_round": runs["taa fused"]["launches"]["taa_round"],
                **model_launches}
    rows = []
    for name in ("taa_gram", "taa_apply", "taa_round"):
        t = times[name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=bnd[name]["bound_ms"], bound_by=bnd[name]["bound_by"],
            library_ms=t["library_ms"], device_ms=t["device_ms"],
            plain_device_ms=t["plain_device_ms"],
            library_device_ms=t["library_device_ms"]))
    keys = ("label", "path", "ms", "device_ms", "plain_ms", "plain_device_ms",
            "library_ms", "library_device_ms", "bound_ms", "bound_by",
            "nbytes", "ops", "achieved_tflops", "achieved_tb_s",
            "max_abs_err", "tol")
    # "flash_attention" counts every attention launch, "flash_attention_tc"
    # those of the tensor-core kernel; "flash_decode" the split passes, with
    # the combine passes beside them
    for name in ("flash_attention", "flash_attention_tc", "flash_decode",
                 "ssd_scan", "rglru_scan"):
        mine = [c for c in cases if c["kernel"] == name]
        c = mine[0]   # the row's numbers are its first case's; all in "cases"
        extra = {"combine_launches": launches["flash_decode_combine"]} \
            if name == "flash_decode" else {}
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
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
