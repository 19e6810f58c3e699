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

7. qwen3-0.6b at full width (28 layers, d 1024, 16/8 heads of 128, d_ff
   3072, vocab 151936, tied embeddings, qk-norm), weights from numpy seed
   0, on a card freed of phase 6: (a) as a ParaTAA denoiser through the
   DiffusionWrapper (latent 8, 16 tokens, out_proj N(0, 0.02^2), float32
   with TF32 off, DDIM T=50): ``run`` with the fused round, staged, and
   ``sequential_sample``, each solve under sync-debug mode "error", every
   launch count set to 0 just before each run and read just after (K3 once
   an iteration fused, K1 and K2 staged, none sequential); x0 within 2e-2
   of sequential; iterations, wall and the denoiser's ms an iteration
   (CUDA events) printed.  (c) as a bf16 LM, batch 4: prefill 3072 tokens
   (above 2048: the blocked attention), 32 ``decode_step``s (the last
   under sync-debug mode "error"), their logits within 2e-2 of the logits'
   scale of ``forward``'s on the same 3104 tokens, and of a float32
   ``forward``'s of the same weights; prefill ms, decode ms a token and
   the cache's bytes printed.  (b) two float32 steps of
   ``repro_torch.launch.train --arch qwen3-0.6b --batch 8 --seq 128`` with
   a checkpoint through ``build/chip_smoke_lm_ckpt`` (deleted after):
   finite losses, the params read back ``torch.equal`` to the trained ones,
   no kernel launched; step wall, forward+backward and update ms printed.

8. mamba2-1.3b, recurrentgemma-2b and qwen2-moe-a2.7b at full width, on a
   card freed of phase 7: (a) mamba2-1.3b (24 of its 48 layers: the depth
   cut ``SSM_LAYERS``; d 2048, 64 SSD heads
   of 64, state 128, chunk 256) as phase 7's wrapper denoiser (numpy seed
   0; fused, staged and sequential under sync-debug mode "error"; K3 once
   an iteration fused, K1 and K2 staged, none sequential; x0 within 2e-2 of
   sequential); (b) the same weights as an LM, batch 4, prefill 4096
   tokens (16 chunks), 32 decode steps; (c) recurrentgemma-2b (8 periods of
   rglru, rglru, attn + a tail of 2; weights drawn on the card, seed 0),
   batch 4, prefill 3072 (past the 2048 window), 32 decodes; (d1)
   qwen2-moe-a2.7b (weights drawn on the card) at a lossless capacity
   factor of 64, batch 2, prefill 256, 32 decodes; each of (b)-(d1) in
   float32 (decode logits within 2e-2 of ``forward``'s over the same
   tokens; 4128 = a padded chunk for mamba2) and then, cast in place, in
   bf16 (finite; within (f)'s bound of both forwards), the last decode
   of each run under sync-debug mode "error", the cache's bytes equal at
   10x the length for (b) and (c); (d2) qwen2-moe-a2.7b in bf16 at its own
   capacity factor 1.25 (slots dropped), batch 4, prefill 2048, 8 decodes,
   finite; each run's prefill ms, decode ms a token and peak memory
   printed; (e) two float32 steps of ``train.py --arch mamba2-1.3b --batch
   8 --seq 128`` with a checkpoint through ``build/chip_smoke_ssm_ckpt``
   (deleted after) read back ``torch.equal``, no kernel launched; (f)
   before (b), mamba2-1.3b's decode against ``forward`` over the same
   prefix (batch 2, prefill 2048, 16 decodes) layer by layer, from the
   hidden state after each layer, in bf16 and float32, beside the bf16
   forward's own distance from float32 (per layer, and each distance's
   mean growth a layer; the bf16 gap below ``BF16_DECODE_FACTOR`` of the
   bf16 forward's in every layer); (b)-(d1)'s bf16 decode is then checked
   within ``BF16_DECODE_FACTOR`` times the bf16 forward's distance from
   float32, of the bf16 forward and of the float32 forward.

9. the serve switches and the dry-run on the card: (a) phase 3's fused
   DiT-XL path and sequential under ``apply_backend_tune(["--backend-
   tune"])`` (TF32), then the switches restored: every request converged,
   x0 within 2e-2 of TF32 sequential, iterations within 2 of phase 3's;
   DiT and rest ms an iteration and the walls printed (run after phase
   3); (b) ``serve.main`` at its own geometry (DiT-XL, 16 tokens, T=50, 2
   requests, phase 3's weights) with ``--use-pallas off`` and ``auto``, in
   turns (off, auto, auto, off), fused and staged: equal iters/nfe, x0
   within 1e-4, no K1-K3 launch with off, K3 once an iteration (fused) or
   K1 and K2 (staged) with auto; walls and the difference an iteration
   printed (run after phase 5); (c) the dry-run
   (``repro_torch.launch.dryrun.run_cell``) on ``meta`` for the bf16
   prefills of phases 7 and 8 (qwen3-0.6b 4 x 3072, mamba2-1.3b 4 x
   4096), then the same prefill on the card under the same counter: its
   FLOPs equal the dry-run's, the dry-run's peak within 25% of
   ``torch.cuda.max_memory_allocated()``; the roofline bound beside the
   measured prefill; (d) ``examples/torch_{train_and_serve,
   trajectory_variation,quickstart}.py`` at their defaults on cuda.

10. placement on ``torch.distributed``, last: a world of one rank over
   NCCL (``init_distributed("cuda")``, a ``file://`` rendezvous in a
   temporary directory), at full DiT-XL width with phase 3's weights.
   (a) phase 3's geometry with phase 9 (a)'s TF32: ``run_batch`` and a
   stepwise drain with a mid-solve refill (3 requests over 2 lanes) on
   ``Placement.for_mesh(make_mesh("debug-time", 1, 1, 1))`` against
   ``Placement.host()``, fused and staged, in turns (host, mesh, mesh,
   host), each solve under sync-debug mode "error": trajectories bit for
   bit, iters, nfe, polls and K1-K3 launches equal; the NCCL collectives
   counted (``repro_torch.comm``: one window all-gather and one poll
   all-reduce an iteration, five output all-gathers a dispatch) and each
   one's wall at the solve's shapes (CUDA events).  (b) ``serve.main`` at
   phase 9 (b)'s geometry with ``--mesh debug --data-parallel 1
   --model-parallel 1`` and with ``--serve-async --chunk-iters 2
   --fuse-round --mesh ... --chaos-drop 1`` (one card: the injector keeps
   the sole survivor) against the same runs without ``--mesh``: equal
   iters, nfe and x0; then a ``ResilientServingLoop`` drain (6 requests, 2
   lanes, T=25, 16 tokens) with one rebuild onto the same card mid-drain
   (``_rebuild``: ``fetch_bank`` -> ``plan_elastic`` -> a new mesh and
   engine -> ``adopt_bank``): every ticket bit for bit the uninterrupted
   drain's; ``rebuild_wall_s`` and the bytes moved printed.
11. the DiT tensor-parallel over ``model`` (``SamplingEngine(param_defs=
   dit_defs)``: each rank's blocks of the parameters, ``dit_apply`` on
   them with its all-reduces and all-gathers), last.  (a) a world of one
   over NCCL on a (1, 1) ``debug`` mesh, phase 10 (a)'s geometry and TF32,
   fused and staged: bit for bit the host placement, equal iters, nfe,
   polls and K1-K3 launches, the NCCL collectives by the formula (2L
   all-reduces and L + 1 all-gathers a DiT call over model; the data
   axis has one rank, so no FSDP all-gather; + a poll all-reduce an
   iteration and 5 output all-gathers a dispatch); one DiT call's ms host
   / TP and each collective's ms at the solve's shapes (CUDA events).
   (b) ``python -m repro_torch.launch.dryrun --parataa --mesh both`` in a
   subprocess: the ParaTAA cell on the pod (256) and multi-pod (512)
   meshes in a fake world, modeled (per-chip FLOPs, bytes, peak and
   ``fits_hbm``, collective bytes by kind and by link).  (c) two
   processes on the one card in a gloo group (gloo takes CUDA tensors),
   ``debug`` with model 2: DiT-XL at full width, 14 of its 28 layers, its 16
   heads split 8 a rank, against the host placement in float32 at 16
   tokens: eps within 1e-5, trajectories within 1e-4, iters and nfe
   equal (fused).
12. the LM backbones tensor-parallel over ``model`` (``models.backbone``
   on a rank's ``ShardedParams`` and ``ShardedCache``), last.  (a) a
   world of one over NCCL on a (1, 1) ``debug`` mesh: qwen3-0.6b at full
   width and depth, float32 with TF32 off, prefill 2 x 512 and 8 decode
   steps bit for bit the host path, each call's collectives by
   ``backbone.tp_collectives``, prefill ms and decode ms a token host /
   TP (CUDA events); phase 7's wrapper (latent 8, 16 tokens, T=50) as
   eps_theta through ``SamplingEngine(param_defs=wrapper_defs)``, staged
   and fused, bit for bit the host placement with equal iters, nfe,
   polls and K1-K3 launches.  (b) two processes on the one card in a
   gloo group (``chip_smoke.py --tp-lm-gloo-rank R DIR``), ``debug`` with
   model 2, float32 at full width: qwen3-0.6b (14 layers),
   recurrentgemma-2b (one period: two RG-LRU layers and local attention
   over an MQA cache split over slots, softcap), mamba2-1.3b (2 layers)
   and qwen2-moe-a2.7b (2 layers: experts over model and the shared
   MLP); each prefill 2 x 512 and 8 decodes within 1e-5 relative of the
   host tree's logits, collectives by the formula, prefill and decode ms
   host / TP; qwen3-0.6b's wrapper engine (fused) with equal iters and
   nfe.  (c) ``python -m repro_torch.launch.dryrun --all --shape
   prefill_32k,decode_32k,long_500k --mesh both`` in a subprocess beside
   13 (c), both on the host's cores beside the kernels' build and waited
   for before phase 2 (no timing runs beside them; no card): every LM
   prefill, decode and long-context cell and the ParaTAA cell on pod
   (256) and multi-pod (512) at full width, rank 0's tensor-parallel
   program in a fake world, one modeled record printed a cell.
13. the tensor-parallel train step (``launch.steps.make_train_step`` on a
   rank's ``ShardedParams``: forward, backward with every collective's
   adjoint, the gradient sync, the mesh's global norm, AdamW on the
   blocks).  (a) a world of one over NCCL on a (1, 1) ``debug`` mesh,
   float32, TF32 off, deterministic algorithms: DiT-XL (28 layers, batch
   16 x 16 tokens) and qwen3-0.6b (28 layers, batch 8 x 128) at full
   width, 3 steps of grad_accum 2, host step against TP step: losses,
   grad norms and every leaf bit for bit, collectives a step by
   ``dit``/``backbone.tp_train_collectives``, step ms host / TP (CUDA
   events), the TP step's allocation peak beside the dry-run's count of
   the same step, no kernel of the port launched.  (b) two processes on
   the one card in a gloo group (``chip_smoke.py --tp-train-gloo-rank R
   DIR``), ``debug`` with model 2, published widths: DiT-XL (4 layers),
   qwen3-0.6b, mamba2-1.3b, qwen2-moe-a2.7b (2 layers each) and
   recurrentgemma-2b (one period), 2 steps against the host step run one
   rank at a time: losses and grad norms within 1e-5 relative, the first
   batch's gradients of each block within 1e-5 of its leaf's largest
   gradient entry, params within 1e-5 of each leaf's largest entry (5e-5
   for the adaLN leaves) where the TP and host gradients agree in sign at
   every step (the rest, at most ``FLIP_SHARE`` of the elements, within 2
   x the steps' learning rates), collectives by the formula.
   (c) ``dryrun --arch dit-xl,qwen3-0.6b --shape train_4k --mesh both``,
   beside 12 (c) and the build: their train_4k cells on pod and
   multi-pod, modeled.

Then one JSON line of per-kernel numbers (K1-K3 with ``wrapper_launches``,
phase 7's, ``ssm_wrapper_launches``, phase 8's,
``use_pallas_auto_launches``, phase 9 (b)'s, ``mesh_launches``, phase
10 (a)'s mesh run, ``tp_launches``, phase 11 (a)'s TP run, and
``tp_lm_launches``, phase 12 (a)'s TP wrapper run; K3 with
``tf32_launches``, phase 9 (a)'s), and last the
line
``{"ok": true, "device": {...}}``.  Without CUDA, or run from a directory
without the repository's ``src/``, it fails before printing any result.
"""
from __future__ import annotations

import contextlib
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
# the H100 SXM constants of every bound here and of the dry-run's
# roofline: one source, repro_torch.roofline.analysis
from repro_torch.roofline.analysis import (  # noqa: E402
    F32_FLOPS as F32_FLOPS_PER_S, HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS as BF16_TC_FLOPS_PER_S, TF32_FLOPS as TF32_TC_FLOPS_PER_S)
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


class TimedCalls:
    """Wraps a function with CUDA events around each call, and the host's
    clock (the call's enqueue: it waits for nothing)."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []
        self.host_ms = []

    def __call__(self, *args):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        start.record()
        out = self.fn(*args)
        stop.record()
        self.host_ms.append((time.monotonic() - t0) * 1e3)
        self.events.append((start, stop))
        return out

    def ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def total_ms(self) -> float:
        return sum(self.ms())


class sync_debug_error:
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block: an
    operation that waits for the card raises."""

    def __enter__(self):
        import torch

        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)


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


def strictly(fn, profiled: bool = False):
    """``fn`` run under ``torch.cuda.set_sync_debug_mode("error")``: any
    wait on the card other than the solver's counted poll (an event wait,
    which the mode does not flag) raises.  ``profiled`` marks each call's
    span ("solve") for a profiler trace."""
    from torch.profiler import record_function

    def strict(*args, **kw):
        with sync_debug_error():
            if profiled:
                with record_function("solve"):
                    return fn(*args, **kw)
            return fn(*args, **kw)
    return strict


def strict_solves(engine, profiled: bool = False):
    """Runs each of ``engine``'s solves (not the packing, not ``collect``)
    ``strictly``."""
    engine._solve = strictly(engine._solve, profiled)
    return engine


def serve_once(label, params, cfg, coeffs, spec, requests):
    """One run of the serving path through ``SamplingEngine.run_batch``,
    every launch count set to 0 just before it and read just after; each
    solve under sync-debug mode (``strict_solves``)."""
    import torch

    from repro_torch.kernels import taa_update
    from repro_torch.launch import serve
    from repro_torch.sampling import SamplingEngine

    timed = TimedCalls(serve.make_eps_apply(cfg))
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

    timed = TimedCalls(serve.make_eps_apply(cfg))
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
        use_pallas="auto", fuse_round=True, batch_size=SERVE_SLOTS,
        chunk_iters=SERVE_CHUNK)


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


# --- phase 7: qwen3-0.6b at full width, as a ParaTAA denoiser and as an LM --

#: phase 7's architecture, wrapper geometry (latent dim, tokens; the
#: example's), the scale of the wrapper's zero-initialized out_proj, and
#: the DDIM steps
LM_ARCH, WRAP_LATENT, WRAP_TOKENS, WRAP_OUT_SCALE, WRAP_T = (
    "qwen3-0.6b", 8, 16, 0.02, 50)
#: (b): the train driver's flags beside --ckpt-dir (the reference's batch
#: and sequence defaults, two steps, one save: the final one)
LM_TRAIN_FLAGS = ["--arch", LM_ARCH, "--batch", "8", "--seq", "128",
                  "--steps", "2", "--ckpt-every", "1000", "--log-every", "1"]
#: (c): batch, prompt tokens (above the blocked-attention threshold of
#: 2048) and decode steps
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 3072, 32
#: qwen3-0.6b's parameters (tied embeddings; ``build_defs``)
QWEN3_PARAMS = 596_049_920


@contextlib.contextmanager
def strict_parataa():
    """Runs each ParaTAA solve (``core.parataa.sample``, which ``run``
    calls) ``strictly`` within the block; ``run``'s reads of the result
    afterwards are outside it."""
    from repro_torch.core import parataa

    real = parataa.sample
    parataa.sample = strictly(real)
    try:
        yield
    finally:
        parataa.sample = real


def wrapper_denoiser(cfg, params, phase="phase 7"):
    """(a): ParaTAA fused, staged and sequential DDIM (T=50) on one request
    of 16 latent tokens with the wrapper of ``cfg`` as eps_theta, float32 with
    TF32 off: a warm-up pass of the three, then the measured one, launches
    read per run; each solve under sync-debug mode."""
    import numpy as np
    import torch

    from repro_torch.core import ddim_coeffs
    from repro_torch.diffusion import dit
    from repro_torch.sampling import (draw_noises, get_sampler, run,
                                      sequential_sample)

    cuda = torch.device("cuda")
    coeffs = ddim_coeffs(WRAP_T)
    xi = draw_noises(SEED, coeffs, (WRAP_TOKENS, WRAP_LATENT), device=cuda)

    def eps(x, taus):
        return dit.wrapper_apply(params, cfg, x, taus)

    def solve(spec):
        timed = TimedCalls(eps)
        reset_all_launches()
        t0 = time.monotonic()
        if spec is None:
            with sync_debug_error():
                x0 = sequential_sample(timed, coeffs, xi)
            iters = nfe = WRAP_T
            converged = True
        else:
            with strict_parataa():
                res = run(spec, timed, coeffs, xi)
            x0, iters, nfe, converged = (res.x0, res.iters, res.nfe,
                                         res.converged)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        return dict(x0=x0.float().cpu().numpy(), iters=iters, nfe=nfe,
                    converged=converged, wall_s=wall,
                    launches=all_launches(), eps_ms=timed.ms(),
                    eps_host_ms=timed.host_ms)

    specs = (("fused", get_sampler("taa", fuse_round=True)),
             ("staged", get_sampler("taa")), ("seq", None))
    with torch.no_grad():
        warm_s = time.monotonic()
        for _, spec in specs:       # cuBLAS picks its kernels per shape
            solve(spec)
        print(f"{phase} wrapper warm-up pass {time.monotonic() - warm_s} s")
        runs = {}
        for label, spec in specs:
            r = runs[label] = solve(spec)
            ms = r["eps_ms"]
            print(f"{phase} wrapper {label}: iters {r['iters']} nfe "
                  f"{r['nfe']} of T={WRAP_T}, wall {r['wall_s']} s, "
                  f"{len(ms)} denoiser calls, denoiser "
                  f"{sum(ms) / max(r['iters'], 1)} ms an iteration (median "
                  f"call {statistics.median(ms)} ms; host enqueue "
                  f"{statistics.median(r['eps_host_ms'])} ms), kernel "
                  f"launches {r['launches']}")
            check(r["converged"], f"{phase} {label}: not converged")
        # one denoiser call at each run's shape under the profiler: what a
        # call costs the card, apart from its launches
        rows = runs["staged"]["nfe"] // runs["staged"]["iters"]
        for n in (rows, 1):
            _, ops, busy = profiled(lambda: eps(
                xi[:1].expand(n, -1, -1), torch.zeros(n, device=cuda)))
            print(f"{phase} wrapper one denoiser call on {n} x "
                  f"{WRAP_TOKENS} tokens under torch.profiler: {ops} "
                  f"device ops, busy {busy} ms")
    seq = runs["seq"]["x0"]
    zero = {name: 0 for name in all_launches()}
    check(runs["seq"]["launches"] == zero,
          f"{phase} seq launches {runs['seq']['launches']}")
    for label, want in (("fused", {"taa_round"}),
                        ("staged", {"taa_gram", "taa_apply"})):
        r = runs[label]
        err = float(np.max(np.abs(r["x0"] - seq)) / np.max(np.abs(seq)))
        r["err"] = err
        print(f"{phase} wrapper {label}: x0 against sequential rel err "
              f"{err} (bound 2e-2); wall {r['wall_s']} s against "
              f"sequential's {runs['seq']['wall_s']} s")
        check(r["x0"].shape == (WRAP_TOKENS, WRAP_LATENT)
              and np.all(np.isfinite(r["x0"])), f"{phase} {label} x0")
        check(err < 2e-2, f"{phase} {label} x0 off sequential by {err}")
        expect = {k: (r["iters"] if k in want else 0) for k in zero}
        check(r["launches"] == expect,
              f"{phase} {label} launches {r['launches']} != {expect}")
    return runs


def lm_train(ckpt_dir: Path, flags=LM_TRAIN_FLAGS, n_expect=QWEN3_PARAMS,
             phase="phase 7"):
    """(b): two float32 steps of ``repro_torch.launch.train`` with
    ``flags`` (qwen3-0.6b, batch 8, seq 128) and a checkpoint through
    ``ckpt_dir`` (deleted after), the saved params read back; ``n_expect``
    parameters."""
    import shutil

    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.tree import leaves

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        res = train.run(flags + ["--ckpt-dir", str(ckpt_dir)])
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated()
        for st in res.step_ms:
            print(f"{phase} train step {st}")
        print(f"{phase} train: losses {res.losses}, kernel launches "
              f"{launches}, peak memory allocated {peak} B")
        check(len(res.losses) == 2
              and all(math.isfinite(x) for x in res.losses),
              f"{phase} train losses {res.losses}")
        check(not any(launches.values()),
              f"{phase} train launched {launches}")
        step_dir = ckpt_dir / "step_00000002"
        nbytes = sum(p.stat().st_size for p in step_dir.iterdir())
        params = res.state["params"]
        res.state = None
        free_card()
        t0 = time.monotonic()
        step, tree = CheckpointManager(ckpt_dir).restore(
            {"step": 0, "params": params})
        read_s = time.monotonic() - t0
        same = all(torch.equal(x, y) for x, y in zip(
            leaves(tree["params"]), leaves(params)))
        n_params = sum(x.numel() for x in leaves(params))
        print(f"{phase} checkpoint step {step}: {nbytes} B on disk, "
              f"{n_params} parameters; params read back in {read_s} s, "
              f"equal to the trained ones (torch.equal): {same}")
        check(step == 2 and same, f"{phase} restored params != trained")
        check(n_params == n_expect, f"{phase}: {n_params} parameters")
        return res.step_ms
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def profiled(fn):
    """(fn's result, the number of device ops it ran, their summed device
    ms) under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return out, len(spans), sum(spans) / 1e3


def lm_prefill_decode(cfg, params):
    """(c): bf16, batch 4: prefill 3072 tokens (the blocked attention), 32
    decode steps, their logits against ``forward``'s on the same 3104
    tokens, and both against a float32 ``forward`` of the same weights
    (widened); one decode step under sync-debug mode."""
    import numpy as np
    import torch

    from repro_torch.models import backbone
    from repro_torch.tree import map_tree

    cuda = torch.device("cuda")
    total = LM_PROMPT + LM_DECODE
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, total)).astype(np.int32)).to(cuda)
    cache = backbone.init_cache(cfg, LM_BATCH, total, torch.bfloat16, cuda)
    cache_bytes = sum(x.numel() * x.element_size() for x in cache.values())
    reset_all_launches()
    with torch.no_grad():
        prefill = TimedCalls(lambda: backbone.prefill(
            params, cfg, tokens[:, :LM_PROMPT], cache))
        for _ in range(2):     # the same slots again: the second is timed
            last, _ = prefill()
        step = TimedCalls(lambda t: backbone.decode_step(params, cfg, t,
                                                         cache))
        outs = []
        for i in range(LM_DECODE):
            tok = tokens[:, LM_PROMPT + i:LM_PROMPT + i + 1]
            if i == LM_DECODE - 2:
                (logits, _), device_ops, busy_ms = profiled(
                    lambda: step(tok))
            elif i == LM_DECODE - 1:
                torch.cuda.synchronize()
                with sync_debug_error():
                    logits, _ = step(tok)
            else:
                logits, _ = step(tok)
            outs.append(logits)
        dec = torch.cat(outs, dim=1).float()
        ref, _ = backbone.forward(params, cfg, tokens)
        ref_last = ref[:, LM_PROMPT - 1].float()
        ref = ref[:, LM_PROMPT:].float()
        ref32, _ = backbone.forward(map_tree(lambda x: x.float(), params),
                                    cfg, tokens)
        ref32 = ref32[:, LM_PROMPT:].clone()
    launches = all_launches()
    scale = float(ref.abs().max())
    err = float((dec - ref).abs().max()) / scale
    err_last = float((last[:, 0].float() - ref_last).abs().max()) / scale
    scale32 = float(ref32.abs().max())
    err32 = float((dec - ref32).abs().max()) / scale32
    fwd_err32 = float((ref - ref32).abs().max()) / scale32
    index = int(cache["index"][0])
    dms = step.ms()[1:LM_DECODE - 2]       # not the profiled or strict
    host = step.host_ms[1:LM_DECODE - 2]
    print(f"phase 7 LM bf16 batch {LM_BATCH}: prefill {LM_PROMPT} tokens "
          f"{prefill.ms()[-1]} ms (first {prefill.ms()[0]} ms); decode "
          f"{statistics.median(dms)} ms a token on the card, host enqueue "
          f"{statistics.median(host)} ms (medians of steps 2-"
          f"{LM_DECODE - 2}; first {step.ms()[0]} ms); one step under "
          f"torch.profiler: {device_ops} device ops, busy {busy_ms} ms; "
          f"cache {cache_bytes} B, index "
          f"{index}; decode logits against forward's rel err {err}, the "
          f"prefill's last {err_last} (bound 2e-2, logits' scale {scale}); "
          f"against the float32 forward's: decode {err32} (bound 2e-2), "
          f"the bf16 forward {fwd_err32} (logits' scale {scale32}); "
          f"kernel launches {launches}; the last decode step under "
          f"sync-debug mode \"error\"")
    check(index == total, f"phase 7 cache index {index}")
    check(bool(torch.isfinite(dec).all()), "phase 7 decode logits finite")
    check(err < 2e-2 and err_last < 2e-2,
          f"phase 7 decode off forward by {err} / {err_last}")
    check(err32 < 2e-2, f"phase 7 decode off the float32 forward by {err32}")
    check(not any(launches.values()), f"phase 7 LM launched {launches}")
    return dict(prefill_ms=prefill.ms()[-1], decode_ms=statistics.median(dms),
                err=err, err32=err32, fwd_err32=fwd_err32,
                cache_bytes=cache_bytes)


def backbone_path(ckpt_dir: Path):
    """Phase 7: qwen3-0.6b at full width (28 layers, d 1024, 16/8 heads of
    128, d_ff 3072, vocab 151936, tied, qk-norm), weights from numpy seed
    0: (a) as the wrapper denoiser, (c) as a bf16 LM, then (b) trained by
    the driver on a card freed of both."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.diffusion.convert import wrapper_init
    from repro_torch.models.backbone import build_defs
    from repro_torch.models.pdefs import cast_params_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(LM_ARCH)
    t0 = time.monotonic()
    params = wrapper_init(cfg, WRAP_LATENT, SEED, torch.device("cuda"),
                          out_scale=WRAP_OUT_SCALE)
    torch.cuda.synchronize()
    print(f"phase 7 {LM_ARCH}: {cfg.num_layers} layers d={cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}, wrapper params made in "
          f"{time.monotonic() - t0} s (numpy seed {SEED}, out_proj N(0, "
          f"{WRAP_OUT_SCALE}^2))")
    wrap = wrapper_denoiser(cfg, params)
    lm = params.pop("backbone")
    cast_params_(build_defs(cfg), lm, torch.bfloat16)
    del params
    free_card()
    decode = lm_prefill_decode(cfg, lm)
    del lm
    free_card()
    steps = lm_train(ckpt_dir)
    return dict(wrap=wrap, decode=decode, steps=steps)


# --- phase 8: mamba2, the RG-LRU hybrid and MoE at full width ---------------

SSM_ARCH, HYBRID_ARCH, MOE_ARCH = ("mamba2-1.3b", "recurrentgemma-2b",
                                   "qwen2-moe-a2.7b")
#: (e): the train driver's flags beside --ckpt-dir
SSM_TRAIN_FLAGS = ["--arch", SSM_ARCH, "--batch", "8", "--seq", "128",
                   "--steps", "2", "--ckpt-every", "1000", "--log-every", "1"]
#: the parameters of mamba2-1.3b's and recurrentgemma-2b's ``build_defs``
MAMBA2_PARAMS, RGEMMA_PARAMS = 1_343_532_032, 2_688_089_600
#: (a), (b) and (f)'s mamba2-1.3b depth (48 published; widths are the
#: published ones): cut so that the script stays inside its time limit;
#: (e) trains the whole model
SSM_LAYERS = 24


def tree_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(x.numel() * x.element_size() for x in leaves(tree))


def lm_run(phase, cfg, params, batch, prompt, decode, *, reference=True):
    """``batch`` sequences of random tokens (numpy seed 0): prefill
    ``prompt`` tokens (twice, the second timed), ``decode`` decode steps
    (the last under sync-debug mode "error"), and with ``reference``
    ``forward`` over the same prompt + decode tokens; every launch count
    set to 0 before and read after.  The logits come back on the host."""
    import numpy as np
    import torch

    from repro_torch.models import backbone
    from repro_torch.tree import leaves

    cuda = torch.device("cuda")
    total = prompt + decode
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, total)).astype(np.int32)).to(cuda)
    dtype = params["embed"].dtype
    cache = backbone.init_cache(cfg, batch, total, dtype, cuda)
    cache_bytes = tree_bytes(cache)
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        prefill = TimedCalls(lambda: backbone.prefill(
            params, cfg, tokens[:, :prompt], cache))
        for _ in range(2):     # from a zero cache each time
            for leaf in leaves(cache):
                leaf.zero_()
            last, _ = prefill()
        step = TimedCalls(lambda t: backbone.decode_step(params, cfg, t,
                                                         cache))
        outs = []
        for i in range(decode):
            tok = tokens[:, prompt + i:prompt + i + 1]
            if i == decode - 1:
                torch.cuda.synchronize()
                with sync_debug_error():
                    logits, _ = step(tok)
            else:
                logits, _ = step(tok)
            outs.append(logits)
        dec = torch.cat(outs, dim=1).float().cpu()
        last = last[:, 0].float().cpu()
        index = int(backbone.cache_index(cfg, cache))
        del cache, outs, logits
        free_card()
        ref = None
        if reference:
            ref = backbone.forward(params, cfg, tokens)[0][
                :, prompt - 1:].float().cpu()
    out = dict(dec=dec, last=last, ref=ref, index=index,
               cache_bytes=cache_bytes, prefill_ms=prefill.ms()[-1],
               prefill_first_ms=prefill.ms()[0],
               decode_ms=statistics.median(step.ms()[1:decode - 1]),
               decode_host_ms=statistics.median(step.host_ms[1:decode - 1]),
               peak=torch.cuda.max_memory_allocated(),
               launches=all_launches())
    print(f"{phase} LM {str(dtype)[6:]} batch {batch}: prefill {prompt} "
          f"tokens {out['prefill_ms']} ms (first {out['prefill_first_ms']} "
          f"ms); decode {out['decode_ms']} ms a token on the card, host "
          f"enqueue {out['decode_host_ms']} ms (medians of steps 2-"
          f"{decode - 1}); cache {cache_bytes} B, index {index}; peak memory "
          f"allocated {out['peak']} B; kernel launches {out['launches']}; "
          f"the last decode step under sync-debug mode \"error\"")
    check(index == total, f"{phase} cache index {index}")
    check(bool(torch.isfinite(dec).all()), f"{phase} decode logits finite")
    check(not any(out["launches"].values()),
          f"{phase} LM launched {out['launches']}")
    return out


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def lm_check(phase, cfg, params, batch, prompt, decode, *,
             const_memory=True):
    """The model in float32, then (cast in place) in bf16, through
    :func:`lm_run`.  Checks: in float32, the decode logits (and the
    prefill's last) within 2e-2 of the logits' scale of ``forward``'s
    over the same tokens; in bf16, finite and within
    ``BF16_DECODE_FACTOR`` times the bf16 forward's distance from the
    float32 forward, of each forward (bf16 rounding compounds over depth:
    phase 8 (f)).
    ``const_memory``: the cache's bytes equal at 10x the length."""
    import torch

    from repro_torch.models import backbone
    from repro_torch.models.pdefs import cast_params_

    if const_memory:
        total = prompt + decode
        small, big = (tree_bytes(backbone.init_cache(
            cfg, batch, n, torch.bfloat16, torch.device("cuda")))
            for n in (total, 10 * total))
        print(f"{phase} cache bytes at max_seq {total}: {small}, at "
              f"{10 * total}: {big}")
        check(small == big, f"{phase} cache grows: {small} -> {big}")
    r32 = lm_run(phase, cfg, params, batch, prompt, decode)
    ref = r32["ref"]
    err, err_last = rel(r32["dec"], ref[:, 1:]), rel(r32["last"], ref[:, 0])
    print(f"{phase} float32: decode logits against forward's over "
          f"{prompt + decode} tokens rel err {err}, the prefill's last "
          f"{err_last} (bound 2e-2; logits' scale "
          f"{float(ref.abs().max())})")
    check(err < 2e-2 and err_last < 2e-2,
          f"{phase} float32 decode off forward by {err} / {err_last}")
    cast_params_(backbone.build_defs(cfg), params, torch.bfloat16)
    free_card()
    r16 = lm_run(phase, cfg, params, batch, prompt, decode)
    d_dec, d_fwd = rel(r16["dec"], r16["ref"][:, 1:]), rel(r16["ref"], ref)
    d_dec32 = rel(r16["dec"], ref[:, 1:])
    print(f"{phase} bf16: decode logits against the bf16 forward's rel err "
          f"{d_dec}, against the float32 forward's {d_dec32}; the bf16 "
          f"forward against the float32 one {d_fwd}; decode's distances "
          f"{d_dec / d_fwd}, {d_dec32 / d_fwd} of the bf16 forward's "
          f"(bound {BF16_DECODE_FACTOR} each, phase 8 (f))")
    check(d_dec < BF16_DECODE_FACTOR * d_fwd
          and d_dec32 < BF16_DECODE_FACTOR * d_fwd,
          f"{phase} bf16 decode off the bf16 forward by {d_dec}, the "
          f"float32 forward by {d_dec32}: {d_dec / d_fwd}, "
          f"{d_dec32 / d_fwd} of the bf16 forward's distance from float32")
    return dict(float32=r32, bfloat16=r16, err=err, err_last=err_last,
                bf16_ratio=d_dec / d_fwd)


def ssm_moe_path(ckpt_dir: Path):
    """Phase 8: (a) mamba2-1.3b at full width (SSM_LAYERS of its layers)
    as the wrapper denoiser (numpy seed 0), (b) the same weights as an LM,
    (c) recurrentgemma-2b
    and (d) qwen2-moe-a2.7b as LMs (weights drawn on the card, seed 0),
    each in float32 and bf16, (e) mamba2-1.3b trained by the driver."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.diffusion.convert import wrapper_init
    from repro_torch.models import backbone
    from repro_torch.models.convert import backbone_init_on_device
    from repro_torch.models.pdefs import param_count

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    t0 = time.monotonic()
    cfg = dataclasses.replace(get_arch(SSM_ARCH), num_layers=SSM_LAYERS)
    params = wrapper_init(cfg, WRAP_LATENT, SEED, cuda,
                          out_scale=WRAP_OUT_SCALE)
    torch.cuda.synchronize()
    print(f"phase 8 {SSM_ARCH}: {cfg.num_layers} layers d={cfg.d_model} "
          f"d_inner={cfg.d_inner} {cfg.ssm_nheads} SSD heads x "
          f"{cfg.ssm_head_dim} state {cfg.ssm_state} chunk {cfg.ssm_chunk}, "
          f"{param_count(backbone.build_defs(cfg))} backbone parameters "
          f"({cfg.param_count()} by the config's count); wrapper params "
          f"made in {time.monotonic() - t0} s (numpy seed {SEED})")
    out["wrap"] = wrapper_denoiser(cfg, params, phase="phase 8 (a)")
    t1 = time.monotonic()
    lm = params.pop("backbone")
    del params
    free_card()
    out["layers"] = layer_by_layer(cfg, lm)
    free_card()
    out["ssm"] = lm_check("phase 8 (b)", cfg, lm, 4, 4096, 32)
    del lm
    free_card()
    t2 = time.monotonic()

    cfg = get_arch(HYBRID_ARCH)
    lm = backbone_init_on_device(cfg, SEED, cuda, dtype=torch.float32)
    n = param_count(backbone.build_defs(cfg))
    print(f"phase 8 (c) {HYBRID_ARCH}: {cfg.num_layers} layers "
          f"{backbone.hybrid_layout(cfg)} d={cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim} window "
          f"{cfg.window_size} softcap {cfg.logit_softcap} vocab "
          f"{cfg.vocab_size}, {n} parameters ({cfg.param_count()} by the "
          f"config's count), drawn on the card (seed {SEED})")
    check(n == RGEMMA_PARAMS, f"phase 8 (c): {n} parameters")
    out["hybrid"] = lm_check("phase 8 (c)", cfg, lm, 4, 3072, 32)
    del lm
    free_card()
    t3 = time.monotonic()

    cfg = get_arch(MOE_ARCH)
    lm = backbone_init_on_device(cfg, SEED, cuda, dtype=torch.float32)
    print(f"phase 8 (d) {MOE_ARCH}: {cfg.num_layers} layers d={cfg.d_model}"
          f" {cfg.num_experts} routed experts padded to "
          f"{lm['layers']['moe']['we_gate'].shape[1]}, top-{cfg.moe_top_k}, "
          f"{cfg.num_shared_experts} shared fused, "
          f"{param_count(backbone.build_defs(cfg))} parameters drawn on the "
          f"card (seed {SEED}), {tree_bytes(lm)} B in float32")
    lossless = dataclasses.replace(cfg, moe_capacity_factor=64.0)
    out["moe"] = lm_check("phase 8 (d1) capacity factor 64", lossless, lm,
                          2, 256, 32, const_memory=False)
    out["moe_drop"] = lm_run("phase 8 (d2) capacity factor 1.25", cfg, lm,
                             4, 2048, 8, reference=False)
    del lm
    free_card()
    t4 = time.monotonic()
    out["steps"] = lm_train(ckpt_dir, SSM_TRAIN_FLAGS, MAMBA2_PARAMS,
                            phase="phase 8 (e)")
    print(f"phase 8 seconds: (a) {t1 - t0}, (b) {t2 - t1}, (c) {t3 - t2}, "
          f"(d) {t4 - t3}, (e) {time.monotonic() - t4}")
    return out


# --- phase 8 (f): bf16 decode against bf16 forward, layer by layer ---------

#: (f): batch, prompt tokens (8 chunks) and decode steps
LAYER_BATCH, LAYER_PROMPT, LAYER_DECODE = 2, 2048, 16
#: the bf16 runs' bound (phase 8 (b)-(d1)), from (f)'s measurement: the
#: decode gap is bf16 rounding (the first layer's products at another
#: row count) grown a layer at the rate bf16 grows away from float32, so
#: decode's logits lie within this multiple of the bf16 forward's own
#: distance from the float32 forward, both of the bf16 forward's and of
#: the float32 forward's (measured 0.15-0.65 of it in every layer, 0.52-
#: 0.87 and 1.04-1.17 at the logits of the four runs; PERF.md §6)
BF16_DECODE_FACTOR = 1.5


class LayerRecorder:
    """While active, keeps each layer's output hidden state (at the
    positions ``sl``, in float32) as ``backbone.trunk`` produces it."""

    def __init__(self):
        from repro_torch.models import backbone

        self.mod, self.real = backbone, backbone._apply_layer
        self.states, self.sl = [], slice(None)

    def __enter__(self):
        def recording(*args, **kw):
            h, aux = self.real(*args, **kw)
            self.states.append(h[:, self.sl].float().clone())
            return h, aux
        self.mod._apply_layer = recording
        return self

    def __exit__(self, *exc):
        self.mod._apply_layer = self.real

    def take(self):
        out, self.states = self.states, []
        return out


def layer_states(cfg, params, tokens, prompt, decode):
    """Per layer, the (B, decode, d) hidden states at the decode positions:
    from ``forward`` over all the tokens, and from ``prefill`` of the
    prompt then ``decode`` steps.  Returns (forward's, decode's, forward's
    logits there, decode's logits)."""
    import torch

    from repro_torch.models import backbone

    dtype = params["embed"].dtype
    with torch.no_grad(), LayerRecorder() as rec:
        rec.sl = slice(prompt, prompt + decode)
        logits, _ = backbone.forward(params, cfg, tokens)
        fwd = rec.take()
        fwd_logits = logits[:, prompt:prompt + decode].float()
        del logits
        cache = backbone.init_cache(cfg, tokens.shape[0], prompt + decode,
                                    dtype, tokens.device)
        rec.sl = slice(None)
        backbone.prefill(params, cfg, tokens[:, :prompt], cache)
        rec.take()
        steps, outs = [], []
        for i in range(decode):
            out, _ = backbone.decode_step(
                params, cfg, tokens[:, prompt + i:prompt + i + 1], cache)
            outs.append(out.float())
            steps.append(rec.take())
    dec = [torch.cat([s[l] for s in steps], dim=1) for l in range(len(fwd))]
    return fwd, dec, fwd_logits, torch.cat(outs, dim=1)


def layer_by_layer(cfg, params32):
    """Phase 8 (f): mamba2-1.3b's decode against its forward over the same
    prefix, layer by layer from the hidden state after each layer, in bf16
    and in float32, beside the bf16 forward's own distance from float32:
    where the decode gap grows, and whether it grows as bf16 rounding
    does."""
    import math

    import numpy as np
    import torch

    from repro_torch.models import backbone
    from repro_torch.models.pdefs import leaf_dtype, map_defs, get_path

    defs = backbone.build_defs(cfg)
    params16 = map_defs(lambda path, spec: get_path(params32, path).to(
        leaf_dtype(spec, torch.bfloat16)), defs)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LAYER_BATCH, LAYER_PROMPT + LAYER_DECODE))
        .astype(np.int32)).to(params32["embed"].device)
    t0 = time.monotonic()
    f32, d32, lf32, ld32 = layer_states(cfg, params32, tokens, LAYER_PROMPT,
                                        LAYER_DECODE)
    f16, d16, lf16, ld16 = layer_states(cfg, params16, tokens, LAYER_PROMPT,
                                        LAYER_DECODE)
    del params16
    rows = []
    for l in range(len(f32)):
        rows.append(dict(layer=l, dec16_fwd16=rel(d16[l], f16[l]),
                         fwd16_fwd32=rel(f16[l], f32[l]),
                         dec16_fwd32=rel(d16[l], f32[l]),
                         dec32_fwd32=rel(d32[l], f32[l])))
    logits = dict(dec16_fwd16=rel(ld16, lf16), fwd16_fwd32=rel(lf16, lf32),
                  dec16_fwd32=rel(ld16, lf32), dec32_fwd32=rel(ld32, lf32))
    print(f"phase 8 (f) {SSM_ARCH} layer by layer (batch {LAYER_BATCH}, "
          f"prefill {LAYER_PROMPT}, {LAYER_DECODE} decodes; each distance "
          f"max|a - b| / max|b| of the hidden state after the layer at the "
          f"decode positions; {time.monotonic() - t0} s):")
    print("phase 8 (f) per layer: dec16/fwd16 = bf16 decode vs bf16 "
          "forward, fwd16/fwd32 = bf16 forward vs float32 forward, "
          "dec16/fwd32, dec32/fwd32 = float32 decode vs float32 forward")
    for r in rows:
        print(f"phase 8 (f) layer {r['layer']}: {r['dec16_fwd16']} "
              f"{r['fwd16_fwd32']} {r['dec16_fwd32']} {r['dec32_fwd32']}")

    def growth(key):
        """The mean factor a layer multiplies the distance by (geometric,
        over the layers after the first where it is nonzero)."""
        vals = [r[key] for r in rows if r[key] > 0]
        if len(vals) < 2:
            return None
        return math.exp((math.log(vals[-1]) - math.log(vals[0]))
                        / (len(vals) - 1))

    ratio = [r["dec16_fwd16"] / r["fwd16_fwd32"] for r in rows
             if r["fwd16_fwd32"] > 0]
    summary = dict(logits=logits, growth={k: growth(k) for k in (
        "dec16_fwd16", "fwd16_fwd32", "dec16_fwd32", "dec32_fwd32")},
        ratio_min=min(ratio), ratio_max=max(ratio),
        first_nonzero={k: next((r["layer"] for r in rows if r[k] > 0), None)
                       for k in ("dec16_fwd16", "fwd16_fwd32",
                                 "dec32_fwd32")})
    print(f"phase 8 (f) logits: {logits}; mean growth a layer "
          f"{summary['growth']}; bf16 decode-vs-forward over the bf16 "
          f"forward's distance from float32, per layer, from "
          f"{summary['ratio_min']} to {summary['ratio_max']}; first layer "
          f"with a nonzero distance {summary['first_nonzero']}")
    check(all(math.isfinite(v) for v in logits.values()),
          "phase 8 (f): a distance is not finite")
    check(summary["ratio_max"] < BF16_DECODE_FACTOR,
          f"phase 8 (f): bf16 decode's gap {summary['ratio_max']} of the "
          f"bf16 forward's distance from float32 in a layer")
    check(logits["dec32_fwd32"] < 2e-2,
          f"phase 8 (f): float32 decode off forward by "
          f"{logits['dec32_fwd32']}")
    return dict(rows=rows, **summary)


# --- phase 9: the serve switches and the dry-run on the card ----------------

#: (b): serve.main's own geometry (DiT-XL at full width, 16 tokens, T=50)
USE_PALLAS_FLAGS = ["--steps-T", "50", "--requests", "2", "--batch-size",
                    "2"]
#: (c): the prefills of phases 7 and 8, bf16: (arch, batch, prompt)
DRYRUN_CELLS = (("qwen3-0.6b", 4, 3072), ("mamba2-1.3b", 4, 4096))


def tf32_path(params, cfg, runs):
    """Phase 9 (a): phase 3's fused DiT-XL path (and sequential) with the
    switches ``--backend-tune`` sets (TF32), then the switches restored."""
    import numpy as np

    from repro_torch.core import ddim_coeffs
    from repro_torch.launch.backend import (apply_backend_tune, read_settings,
                                            write_settings)
    from repro_torch.sampling import get_sampler

    before = read_settings()
    check(apply_backend_tune(["--backend-tune"]),
          f"phase 9 (a): --backend-tune changed nothing ({before})")
    try:
        print(f"phase 9 (a) switches {read_settings()} (were {before})")
        coeffs = ddim_coeffs(T_STEPS)
        requests = [r.request for r in runs["taa fused"]["results"]]
        out = {}
        for label, spec in (
                ("taa fused", get_sampler("taa", fuse_round=True,
                                          order_k=ORDER_K,
                                          history_m=HISTORY_M)),
                ("seq", get_sampler("seq"))):
            out[label] = serve_once(f"phase 9 (a) TF32 {label}", params, cfg,
                                    coeffs, spec, requests)
    finally:
        write_settings(before)
    f32_iters = runs["taa fused"]["device_iters"]
    fused = out["taa fused"]
    iters = fused["device_iters"]
    dit = fused["dit_ms"] / max(iters, 1)
    rest = fused["wall_s"] * 1e3 / max(iters, 1) - dit
    errs, errs32 = [], []
    for r, s, s32 in zip(fused["results"], out["seq"]["results"],
                         runs["seq"]["results"]):
        check(r.converged, f"phase 9 (a): request {r.request} not converged")
        errs.append(float(np.max(np.abs(r.x0 - s.x0)) / np.max(np.abs(s.x0))))
        errs32.append(float(np.max(np.abs(r.x0 - s32.x0))
                            / np.max(np.abs(s32.x0))))
    print(f"phase 9 (a) TF32 fused: {iters} iterations (float32: "
          f"{f32_iters}), DiT {dit} ms/iter, rest {rest} ms/iter, dispatch "
          f"wall {fused['wall_s']} s (float32 {runs['taa fused']['wall_s']} "
          f"s), TF32 sequential wall {out['seq']['wall_s']} s; x0 against "
          f"TF32 sequential rel err {errs} (bound 2e-2), against float32 "
          f"sequential {errs32}; K3 launches {fused['launches']}")
    check(max(errs) < 2e-2, f"phase 9 (a): x0 off TF32 sequential {errs}")
    check(abs(iters - f32_iters) <= 2,
          f"phase 9 (a): {iters} iterations against float32's {f32_iters}")
    check(fused["launches"]["taa_round"] == iters,
          f"phase 9 (a): K3 launches {fused['launches']} != {iters}")
    return dict(iters=iters, dit_ms=dit, rest_ms=rest, wall_s=fused["wall_s"],
                seq_wall_s=out["seq"]["wall_s"], x0_err=errs,
                x0_err_f32=errs32, launches=fused["launches"])


def use_pallas_path(params):
    """Phase 9 (b): ``serve.main --use-pallas off`` against ``auto`` at its
    own geometry, fused and staged, in turns (off, auto, auto, off), with
    phase 3's DiT-XL weights (``serve.dit_init`` returns them: its own
    adaLN-zero init gives eps = 0)."""
    import numpy as np

    from repro_torch.kernels import taa_update
    from repro_torch.launch import serve

    real_init = serve.dit_init
    serve.dit_init = lambda cfg, seed, device: params
    out = {}
    try:
        for mode, flags in (("fused", ["--fuse-round"]), ("staged", [])):
            for value in ("off", "auto", "auto", "off"):
                taa_update.reset_launches()
                t0 = time.monotonic()
                x0, stats = serve.main(USE_PALLAS_FLAGS + flags +
                                       ["--use-pallas", value])
                wall = time.monotonic() - t0
                out.setdefault((mode, value), []).append(dict(
                    x0=x0, iters=[s["iters"] for s in stats],
                    nfe=[s["nfe"] for s in stats], wall_s=wall,
                    launches=dict(taa_update.launches)))
    finally:
        serve.dit_init = real_init
    summary = {}
    for mode in ("fused", "staged"):
        off, auto = out[(mode, "off")], out[(mode, "auto")]
        iters = max(off[0]["iters"])
        err = max(float(np.max(np.abs(a["x0"] - o["x0"]))
                        / np.max(np.abs(o["x0"]))) for a in auto for o in off)
        w_off = [r["wall_s"] for r in off]
        w_auto = [r["wall_s"] for r in auto]
        print(f"phase 9 (b) {mode}: iters off {off[0]['iters']} / auto "
              f"{auto[0]['iters']}, nfe off {off[0]['nfe']} / auto "
              f"{auto[0]['nfe']}; serve.main walls (s, in turns off, auto, "
              f"auto, off) {w_off[0]}, {w_auto[0]}, {w_auto[1]}, {w_off[1]}; "
              f"(off - auto) per iteration "
              f"{(sum(w_off) - sum(w_auto)) / 2 / iters * 1e3} ms; x0 off vs "
              f"auto rel err {err} (bound 1e-4); launches off "
              f"{off[0]['launches']}, auto {auto[0]['launches']}")
        for a, o in zip(auto, off):
            check(a["iters"] == o["iters"] and a["nfe"] == o["nfe"],
                  f"phase 9 (b) {mode}: iters/nfe differ")
            check(not any(o["launches"].values()),
                  f"phase 9 (b) {mode} off launched {o['launches']}")
            want = {"taa_gram": 0, "taa_apply": 0, "taa_round": iters} \
                if mode == "fused" else \
                {"taa_gram": iters, "taa_apply": iters, "taa_round": 0}
            check(a["launches"] == want,
                  f"phase 9 (b) {mode} auto launches {a['launches']} != "
                  f"{want}")
        check(err < 1e-4, f"phase 9 (b) {mode}: x0 off vs auto {err}")
        summary[mode] = dict(iters=iters, wall_off_s=w_off,
                             wall_auto_s=w_auto, x0_err=err,
                             launches=auto[0]["launches"])
    return summary


def dryrun_against_card():
    """Phase 9 (c): the dry-run's cost and memory of the prefills of phases
    7 and 8 (bf16) on ``meta``, then the same prefill on the card under the
    same counter: FLOPs equal, the peak within 25% of
    ``torch.cuda.max_memory_allocated()``; the roofline bound beside the
    measured prefill."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import backbone
    from repro_torch.models.pdefs import init_on_device
    from repro_torch.roofline.counter import CostCounter

    cuda = torch.device("cuda")
    out = {}
    for arch, batch, prompt in DRYRUN_CELLS:
        cfg = get_arch(arch)
        shape = ShapeConfig(f"prefill_{prompt}", prompt, batch, "prefill")
        t0 = time.monotonic()
        rec = dryrun.run_cell(arch, shape)
        meta_s = time.monotonic() - t0
        free_card()
        base = torch.cuda.memory_allocated()
        params = init_on_device(backbone.build_defs(cfg), SEED, cuda,
                                dtype=steps.PARAM_DTYPE)
        cache = steps.abstract_cache(cfg, shape, device=cuda)
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).to(cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad(), CostCounter() as counter:
            counter.track(params, cache, tokens)
            backbone.prefill(params, cfg, tokens, cache)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        with torch.no_grad():
            timed = TimedCalls(lambda: backbone.prefill(params, cfg, tokens,
                                                        cache))
            for _ in range(3):
                timed()
        ms = statistics.median(timed.ms()[1:])
        bound_ms = rec["step_time_lb_s"] * 1e3
        share = abs(rec["peak_bytes"] / peak - 1)
        print(f"phase 9 (c) {arch} bf16 prefill {batch} x {prompt}: dry-run "
              f"on meta ({meta_s} s) {rec['flops_per_chip']} flop "
              f"{rec['flops_by_dtype']}, {rec['bytes_per_chip']} B, peak "
              f"{rec['peak_bytes']} B; on the card the counter's "
              f"{counter.flops} flop, {counter.bytes} B, peak {counter.peak} "
              f"B; torch.cuda.max_memory_allocated {peak} B (above the "
              f"{base} B allocated before), the dry-run's peak off it by "
              f"{share} (bound 0.25); roofline bound {bound_ms} ms "
              f"({rec['dominant']}-bound: compute {rec['compute_s'] * 1e3} "
              f"ms, memory {rec['memory_s'] * 1e3} ms) against the measured "
              f"prefill {ms} ms (median of 2, CUDA events): share "
              f"{bound_ms / ms}")
        check(counter.flops == rec["flops_per_chip"],
              f"phase 9 (c) {arch}: card {counter.flops} flop != meta "
              f"{rec['flops_per_chip']}")
        check(share < 0.25, f"phase 9 (c) {arch}: peak {rec['peak_bytes']} "
              f"vs the card's {peak}")
        out[arch] = dict(rec=rec, card_flops=counter.flops,
                         card_bytes=counter.bytes,
                         card_counter_peak=counter.peak, card_peak=peak,
                         prefill_ms=ms, bound_ms=bound_ms)
        del params, cache, tokens, timed
    free_card()
    return out


def examples_on_card():
    """Phase 9 (d): the three torch examples at their defaults on cuda."""
    import importlib.util

    out = {}
    for name in ("torch_train_and_serve", "torch_trajectory_variation",
                 "torch_quickstart"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.monotonic()
        mod.main([])
        out[name] = time.monotonic() - t0
        print(f"phase 9 (d) {name}: ran at its defaults on cuda in "
              f"{out[name]} s, its checks held")
        free_card()
    return out


# --- phase 4: the model kernels through kernels.ops at model widths ----------


# --- phase 10: placement on torch.distributed, a world of one over NCCL ------

#: (b): serve.main's own geometry, as phase 9 (b)
MESH_FLAGS = ["--mesh", "debug", "--data-parallel", "1", "--model-parallel",
              "1"]
ASYNC_FLAGS = ["--serve-async", "--chunk-iters", "2", "--fuse-round"]


def mesh_drain(engine, requests):
    """A stepwise drain of 3 requests over 2 lanes with a mid-solve
    refill: the first request retires at its quality budget and the third
    takes its lane.  Returns {seed: result}."""
    bank = engine.stepwise_open(2, chunk_iters=2)
    engine.stepwise_refill(bank, [0, 1], requests[:2])
    queued, got, rounds = [requests[2]], {}, 0
    while any(r is not None for r in bank.requests) or queued:
        engine.stepwise_step(bank)
        for lane, res in engine.stepwise_harvest(bank):
            got[res.request.seed] = res
            if queued:
                engine.stepwise_refill(bank, [lane], [queued.pop()])
        rounds += 1
        check(rounds < 200, "phase 10 (a): the drain does not end")
    return got


def same_results(a, b) -> bool:
    return len(a) == len(b) and all(
        x.trajectory.tobytes() == y.trajectory.tobytes()
        and (x.iters, x.nfe) == (y.iters, y.nfe) for x, y in zip(a, b))


def placement_path():
    """Phase 10: the mesh path on a world of one rank over NCCL (a
    ``file://`` rendezvous in a temporary directory) at full DiT-XL
    width.  (a) ``run_batch`` and a stepwise drain with a mid-solve refill
    on ``Placement.for_mesh(make_mesh("debug-time", 1, 1, 1))`` against
    ``Placement.host()``, fused and staged, TF32 on (phase 9 (a)'s
    switches), each solve under sync-debug mode "error"; (b) ``serve.main``
    with ``--mesh debug`` (sync) and ``--serve-async --chaos-drop 1``
    against the same runs without a mesh, and one mid-drain rebuild onto
    the same card through ``ResilientServingLoop._rebuild``."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import comm
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import ddim_coeffs
    from repro_torch.diffusion.convert import dit_init
    from repro_torch.kernels import taa_update
    from repro_torch.launch import serve
    from repro_torch.launch.backend import (apply_backend_tune, read_settings,
                                            write_settings)
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import shardctx
    from repro_torch.sampling import (Placement, SampleRequest,
                                      SamplingEngine, get_sampler)
    from repro_torch.serving import (Batcher, BatchingPolicy,
                                     DeviceLossError, EngineKey,
                                     EngineRegistry, RequestQueue,
                                     ResilientServingLoop)

    cuda = torch.device("cuda")
    rdv = tempfile.mkdtemp(prefix="chip_smoke_rdv_")
    t0 = time.monotonic()
    backend = init_distributed("cuda", world_size=1, rank=0,
                               init_method=f"file://{rdv}/store",
                               timeout_s=300)
    mesh = make_mesh("debug-time", data_parallel=1, time_parallel=1,
                     model_parallel=1, device_type="cuda")
    plc = Placement.for_mesh(mesh)
    print(f"phase 10: {backend} world of {dist.get_world_size()}, "
          f"{plc.describe()}, up in {time.monotonic() - t0} s")
    check(backend == "nccl", f"phase 10: backend {backend}")
    cfg = get_arch("dit-xl")
    params = dit_init(cfg, SEED, cuda, ada_scale=ADA_SCALE)
    coeffs = ddim_coeffs(T_STEPS)
    rng = np.random.default_rng(SEED)
    requests = [SampleRequest(label=int(rng.integers(0, cfg.num_classes)),
                              seed=int(rng.integers(1 << 30)))
                for _ in range(REQUESTS)]
    drain_reqs = [SampleRequest(label=1, seed=11, quality_steps=2),
                  SampleRequest(label=2, seed=12),
                  SampleRequest(label=3, seed=13)]
    taa = dict(order_k=ORDER_K, history_m=HISTORY_M)
    before = read_settings()
    apply_backend_tune(["--backend-tune"])
    out = {}
    try:
        for mode, fuse in (("fused", True), ("staged", False)):
            spec = get_sampler("taa", fuse_round=fuse, **taa)
            runs = {}
            for label, placement in (("host", None), ("mesh", plc),
                                     ("mesh again", plc), ("host again",
                                                           None)):
                engine = strict_solves(SamplingEngine(
                    serve.make_eps_apply(cfg), params, coeffs, spec,
                    sample_shape=(NUM_TOKENS, cfg.latent_dim), device=cuda,
                    placement=placement))
                taa_update.reset_launches()
                comm.reset()
                t1 = time.monotonic()
                res = engine.run_batch(requests, batch_size=REQUESTS)
                wall = time.monotonic() - t1
                d = engine.last_dispatches[0]
                runs[label] = dict(results=res, wall_s=wall,
                                   launches=dict(taa_update.launches),
                                   comm=dict(comm.counts),
                                   iters=d["device_iters"],
                                   polls=d["blocking_polls"])
                if label in ("host", "mesh"):
                    comm.reset()
                    got = mesh_drain(engine, drain_reqs)
                    runs[label]["drain"] = [got[k] for k in sorted(got)]
                    runs[label]["drain_comm"] = dict(comm.counts)
            host, sh = runs["host"], runs["mesh"]
            iters = host["iters"]
            gathers = sh["comm"]["all-gather"]
            print(f"phase 10 (a) {mode}: run_batch iters host {iters} / mesh "
                  f"{sh['iters']}, nfe {[r.nfe for r in host['results']]} / "
                  f"{[r.nfe for r in sh['results']]}; K1-K3 launches host "
                  f"{host['launches']} / mesh {sh['launches']}; blocking "
                  f"polls {host['polls']} / {sh['polls']}; NCCL collectives "
                  f"in the mesh run {sh['comm']} over {sh['iters']} "
                  f"iterations: {(gathers - 5) / max(sh['iters'], 1)} window "
                  f"all-gathers an iteration (+5 output all-gathers), "
                  f"{sh['comm']['all-reduce'] / max(sh['iters'], 1)} poll "
                  f"all-reduces an iteration; walls s (host, mesh, mesh, "
                  f"host) {host['wall_s']}, {sh['wall_s']}, "
                  f"{runs['mesh again']['wall_s']}, "
                  f"{runs['host again']['wall_s']}; drain collectives "
                  f"{sh['drain_comm']}")
            check(same_results(sh["results"], host["results"])
                  and same_results(runs["mesh again"]["results"],
                                   host["results"]),
                  f"phase 10 (a) {mode}: run_batch not bit for bit")
            check(same_results(sh["drain"], host["drain"]),
                  f"phase 10 (a) {mode}: stepwise drain not bit for bit")
            check(sh["launches"] == host["launches"] and sh["iters"] == iters
                  and sh["polls"] == host["polls"],
                  f"phase 10 (a) {mode}: launches/iters/polls differ")
            want = {"taa_round": iters} if fuse else \
                {"taa_gram": iters, "taa_apply": iters}
            check(all(sh["launches"][k] == v for k, v in want.items()),
                  f"phase 10 (a) {mode}: launches {sh['launches']}")
            check(sh["comm"]["all-gather"] == iters + 5
                  and sh["comm"]["all-reduce"] == iters,
                  f"phase 10 (a) {mode}: collectives {sh['comm']}")
            out[mode] = dict(iters=iters, launches=sh["launches"],
                             comm=sh["comm"], wall_host_s=host["wall_s"],
                             wall_mesh_s=sh["wall_s"])
        # the wall of one window all-gather and one poll all-reduce at the
        # solve's shapes (2 lanes x 25 rows x 4096 float32)
        e_w = torch.randn(REQUESTS, T_STEPS, NUM_TOKENS * cfg.latent_dim,
                          device=cuda)
        flag = torch.ones((), dtype=torch.int32, device=cuda)
        with shardctx.use_mesh(mesh):
            gather_ms = cuda_ms(lambda: shardctx.window_gather(
                e_w, "time", 1, T_STEPS))
        reduce_ms = cuda_ms(lambda: comm.all_reduce_min(
            flag, plc.data_group))
        print(f"phase 10 (a) NCCL all_gather of {e_w.numel() * 4} B (one "
              f"window): {gather_ms} ms; all_reduce of the poll flag: "
              f"{reduce_ms} ms (CUDA events, median)")
        out.update(gather_ms=gather_ms, reduce_ms=reduce_ms)
    finally:
        write_settings(before)

    # (b) serve.main with the mesh flags against without, phase 3's weights
    real_init = serve.dit_init
    serve.dit_init = lambda cfg, seed, device: params
    try:
        served = {}
        for label, flags in (("sync", []), ("sync mesh", MESH_FLAGS),
                             ("async", ASYNC_FLAGS),
                             ("async mesh chaos", ASYNC_FLAGS + MESH_FLAGS
                              + ["--chaos-drop", "1"])):
            t1 = time.monotonic()
            x0, stats = serve.main(USE_PALLAS_FLAGS + flags)
            served[label] = dict(x0=x0, iters=[s["iters"] for s in stats],
                                 nfe=[s["nfe"] for s in stats],
                                 wall_s=time.monotonic() - t1)
        for a, b in (("sync", "sync mesh"), ("async", "async mesh chaos")):
            print(f"phase 10 (b) serve.main {b}: iters {served[b]['iters']} "
                  f"nfe {served[b]['nfe']} (without --mesh "
                  f"{served[a]['iters']} / {served[a]['nfe']}); walls "
                  f"{served[a]['wall_s']} / {served[b]['wall_s']} s")
            check(served[a]["iters"] == served[b]["iters"]
                  and served[a]["nfe"] == served[b]["nfe"]
                  and np.array_equal(served[a]["x0"], served[b]["x0"]),
                  f"phase 10 (b): {b} differs from {a}")
    finally:
        serve.dit_init = real_init

    # (b) one mid-drain rebuild onto the same card (a card cannot lose
    # itself, so the rebuild is called, not injected)
    key = EngineKey("dit-xl", T_STEPS, "taa")
    spec = get_sampler("taa", fuse_round=True, **taa)

    def factory(k, placement):
        return SamplingEngine(serve.make_eps_apply(cfg), params,
                              ddim_coeffs(k.T), spec,
                              sample_shape=(16, cfg.latent_dim),
                              device=cuda, placement=placement)

    mesh_plc = Placement.for_mesh(make_mesh("debug", data_parallel=1,
                                            model_parallel=1,
                                            device_type="cuda"))
    traffic = [SampleRequest(label=i, seed=200 + i,
                             **({} if i % 2 else {"quality_steps": 3}))
               for i in range(6)]

    def drain(rebuild_at=None):
        queue = RequestQueue()
        loop = ResilientServingLoop(
            EngineRegistry(lambda k: factory(k, mesh_plc)), queue,
            Batcher(BatchingPolicy(max_batch=2)), engine_factory=factory,
            placement=mesh_plc, chunk_iters=2, min_full_quality_devices=1)
        tickets = [queue.submit(r, key) for r in traffic]
        rounds, lanes = 0, 0
        while len(queue) or loop._occupied_lanes():
            if rounds == rebuild_at:
                lanes = loop._occupied_lanes()
                loop._rebuild(loop._survivors(),
                              DeviceLossError("phase 10 drill"))
            loop.pump(flush=True)
            rounds += 1
        return loop, [t.result(timeout=0) for t in tickets], lanes

    _, base, _ = drain()
    loop, got, lanes = drain(rebuild_at=3)
    res = loop.resilience
    print(f"phase 10 (b) rebuild mid-drain onto the same card: "
          f"{res['rebuilds']} rebuild(s) with {lanes} live lane(s), "
          f"recovered {res['recovered_lanes']}, rebuild_wall_s "
          f"{res['rebuild_wall_s']}, {res['rebuild_bytes']} B moved through "
          f"the host; {len(got)}/{len(traffic)} tickets, iters "
          f"{[r.iters for r in got]}")
    check(res["rebuilds"] == 1 and res["recovered_lanes"] == lanes > 0,
          f"phase 10 (b): rebuild counters {dict(res)}")
    check(same_results(got, base),
          "phase 10 (b): rebuilt drain not bit for bit the uninterrupted one")
    out.update(served={k: dict(iters=v["iters"], nfe=v["nfe"],
                               wall_s=v["wall_s"])
                       for k, v in served.items()},
               rebuild_wall_s=res["rebuild_wall_s"],
               rebuild_bytes=res["rebuild_bytes"])
    del params
    free_card()
    out["moe"] = moe_expert_parallel()
    dist.destroy_process_group()
    shutil.rmtree(rdv, ignore_errors=True)
    return out


def moe_expert_parallel():
    """Phase 10 (c): qwen2-moe-a2.7b's MoE block (weights drawn on the card,
    bf16) at phase 8 (d2)'s shapes — capacity factor 1.25, 4 x 2048 tokens
    — through the expert-parallel function (``moe.expert_parallel``, the
    rank's blocks through the tensor-parallel layer the LM backbones run)
    on a (data 1, model 1) mesh against the local path: at one model rank
    it owns every expert and the same capacity, so the outputs agree bit
    for bit; its one all-reduce (the experts' and shared MLP's partials
    over model; the aux loss moves only over data axes of more than one
    rank) counted and both paths timed."""
    import torch

    from repro_torch import comm
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.pdefs import init_on_device

    cuda = torch.device("cuda")
    cfg = get_arch(MOE_ARCH)
    params = init_on_device(moe.moe_def(cfg), SEED, cuda,
                            dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(SEED + 1)
    x = torch.randn((4, 2048, cfg.d_model), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    mesh = make_mesh("debug", data_parallel=1, model_parallel=1,
                     device_type="cuda")
    with torch.inference_mode():
        y_loc, aux_loc = moe._moe_local(params, cfg, x)
        comm.reset()
        y_ep, aux_ep = moe.expert_parallel(params, cfg, x, mesh)
        counts = dict(comm.counts)
        local_ms = cuda_ms(lambda: moe._moe_local(params, cfg, x),
                           warmup=1, samples=5, reps=2)
        ep_ms = cuda_ms(lambda: moe.expert_parallel(params, cfg, x, mesh),
                        warmup=1, samples=5, reps=2)
    same = torch.equal(y_loc, y_ep) and torch.equal(aux_loc, aux_ep)
    print(f"phase 10 (c) {MOE_ARCH} MoE block, bf16, factor "
          f"{cfg.moe_capacity_factor}, 4 x 2048: expert-parallel at model=1 "
          f"{'bit for bit' if same else 'NOT equal to'} the local path "
          f"(max |dy| {float((y_loc.float() - y_ep.float()).abs().max())}); "
          f"collectives {counts}; ms local {local_ms}, expert-parallel "
          f"{ep_ms} (CUDA events)")
    check(same, "phase 10 (c): expert-parallel MoE differs from local")
    check(counts["all-reduce"] == 1, f"phase 10 (c): collectives {counts}")
    return dict(local_ms=local_ms, ep_ms=ep_ms, collectives=counts)


# --- phase 11: the tensor-parallel DiT and the production dry-run ----------

#: (c): two gloo ranks on the one card, serve.main's 16-token geometry,
#: DiT-XL's width at half its 28 layers (the depth cut that keeps the
#: script inside its time limit)
TP_GLOO_TOKENS, TP_GLOO_LAYERS = 16, 14


def dit_counts(L: int, data: int) -> dict:
    """Collectives of one tensor-parallel DiT call (``diffusion/dit.py``)
    whose every leaf divides its mesh: 2L all-reduces over model; L + 1
    all-gathers over model and, over data axes of more than one rank,
    L + 1 flat all-gathers of the embed rows."""
    return {"all-reduce": 2 * L,
            "all-gather": (L + 1) + (L + 1 if data > 1 else 0)}


def tp_engine_runs(cfg, params, placement, requests, *, num_tokens, defs,
                   strict=True, modes=("fused", "staged")):
    """``run_batch`` of ``requests`` on the host placement, then on
    ``placement`` with ``param_defs=defs`` (the tensor-parallel DiT), for
    each round of ``modes``; each run's K1-K3 launches and collectives
    counted from 0 just before it.  Returns {mode: {label: run}}."""
    from repro_torch import comm
    from repro_torch.core import ddim_coeffs
    from repro_torch.kernels import taa_update
    from repro_torch.launch import serve
    from repro_torch.sampling import SamplingEngine, get_sampler

    device = next(iter(params["blocks"].values())).device
    coeffs = ddim_coeffs(T_STEPS)
    out = {}
    for mode in modes:
        spec = get_sampler("taa", fuse_round=mode == "fused", order_k=ORDER_K,
                           history_m=HISTORY_M)
        for label, plc, pdefs_ in (("host", None, None),
                                   ("tp", placement, defs)):
            engine = SamplingEngine(
                serve.make_eps_apply(cfg), params, coeffs, spec,
                sample_shape=(num_tokens, cfg.latent_dim), device=device,
                placement=plc, param_defs=pdefs_)
            if strict:
                strict_solves(engine)
            taa_update.reset_launches()
            comm.reset()
            t0 = time.monotonic()
            res = engine.run_batch(requests, batch_size=len(requests))
            wall = time.monotonic() - t0
            d = engine.last_dispatches[0]
            out.setdefault(mode, {})[label] = dict(
                results=res, wall_s=wall, launches=dict(taa_update.launches),
                comm={k: comm.counts[k] for k in ("all-gather",
                                                  "all-reduce")},
                iters=d["device_iters"], polls=d["blocking_polls"],
                sharded=engine.denoiser_sharded)
    return out


def rel_traj(a, b) -> float:
    import numpy as np

    return float(max(np.linalg.norm(x.trajectory - y.trajectory)
                     / max(np.linalg.norm(y.trajectory), 1e-30)
                     for x, y in zip(a, b)))


def tensor_parallel_path(phase10=None):
    """Phase 11: the DiT tensor-parallel over ``model`` (``SamplingEngine(
    param_defs=dit_defs)``, ``Placement.shard_params``).  (a) a world of
    one over NCCL on a (1, 1) ``debug`` mesh at full DiT-XL width, phase
    10 (a)'s requests and TF32: fused and staged, bit for bit the host
    placement, equal iters, nfe, polls and K1-K3 launches, the collectives
    by the formula; the DiT's ms a call host / TP and its collectives' ms
    at the solve's shapes (CUDA events).  (b) ``python -m
    repro_torch.launch.dryrun --parataa --mesh both`` in a subprocess:
    the ParaTAA cell on the pod (256) and multi-pod (512) meshes in a
    fake world, modeled.  (c) two gloo ranks on the one card (``debug``,
    model 2: the heads split two ways) against the host
    placement in float32 at 16 tokens, fused: eps within 1e-5,
    trajectories within 1e-4, iters and nfe equal."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.diffusion import dit
    from repro_torch.diffusion.convert import dit_init
    from repro_torch.launch.backend import (apply_backend_tune, read_settings,
                                            write_settings)
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.sampling import Placement, SampleRequest

    cuda = torch.device("cuda")
    rdv = tempfile.mkdtemp(prefix="chip_smoke_rdv_")
    backend = init_distributed("cuda", world_size=1, rank=0,
                               init_method=f"file://{rdv}/store",
                               timeout_s=300)
    check(backend == "nccl", f"phase 11: backend {backend}")
    plc = Placement.for_mesh(make_mesh("debug", data_parallel=1,
                                       model_parallel=1, device_type="cuda"))
    cfg = get_arch("dit-xl")
    L = cfg.num_layers
    params = dit_init(cfg, SEED, cuda, ada_scale=ADA_SCALE)
    defs = dit.dit_defs(cfg)
    rng = np.random.default_rng(SEED)
    requests = [SampleRequest(label=int(rng.integers(0, cfg.num_classes)),
                              seed=int(rng.integers(1 << 30)))
                for _ in range(REQUESTS)]
    before = read_settings()
    apply_backend_tune(["--backend-tune"])
    out = {}
    try:
        runs = tp_engine_runs(cfg, params, plc, requests,
                              num_tokens=NUM_TOKENS, defs=defs)
        per_call = dit_counts(L, 1)
        for mode, r in runs.items():
            host, tp = r["host"], r["tp"]
            iters = tp["iters"]
            print(f"phase 11 (a) {mode}: TP engine on {plc.describe(True)}: "
                  f"iters host {host['iters']} / TP {iters}, nfe "
                  f"{[x.nfe for x in host['results']]} / "
                  f"{[x.nfe for x in tp['results']]}; K1-K3 launches "
                  f"{host['launches']} / {tp['launches']}; polls "
                  f"{host['polls']} / {tp['polls']}; NCCL collectives "
                  f"{tp['comm']} ({per_call} a DiT call); walls s host "
                  f"{host['wall_s']}, TP {tp['wall_s']}")
            check(tp["sharded"], f"phase 11 (a) {mode}: DiT not sharded")
            check(same_results(tp["results"], host["results"]),
                  f"phase 11 (a) {mode}: TP at model 1 not bit for bit")
            check(tp["launches"] == host["launches"]
                  and iters == host["iters"] and tp["polls"] == host["polls"],
                  f"phase 11 (a) {mode}: launches/iters/polls differ")
            want = {"taa_round": iters} if mode == "fused" else \
                {"taa_gram": iters, "taa_apply": iters}
            check(all(tp["launches"][k] == v for k, v in want.items()),
                  f"phase 11 (a) {mode}: launches {tp['launches']}")
            # + the poll flag's all-reduce an iteration and the 5 output
            # all-gathers of the dispatch
            check(tp["comm"] == {
                "all-reduce": iters * (per_call["all-reduce"] + 1),
                "all-gather": iters * per_call["all-gather"] + 5},
                f"phase 11 (a) {mode}: collectives {tp['comm']}")
            out[mode] = dict(iters=iters, launches=tp["launches"],
                             comm=tp["comm"], wall_host_s=host["wall_s"],
                             wall_tp_s=tp["wall_s"])
        # one DiT call at the solve's shape (2 lanes x 25 window rows), the
        # whole tree against the (1, 1) mesh's blocks, and its collectives
        rows = REQUESTS * T_STEPS
        gen = torch.Generator(device=cuda).manual_seed(SEED)
        x = torch.randn(rows, NUM_TOKENS, cfg.latent_dim, generator=gen,
                        device=cuda)
        t = torch.linspace(10.0, 990.0, rows, device=cuda)
        y = torch.arange(rows, device=cuda) % cfg.num_classes
        sharded = plc.shard_params(params, defs)
        with torch.inference_mode():
            host_ms = cuda_ms(lambda: dit.dit_apply(params, cfg, x, t, y),
                              warmup=2, samples=5, reps=2)
            tp_ms = cuda_ms(lambda: dit.dit_apply(sharded, cfg, x, t, y),
                            warmup=2, samples=5, reps=2)
            partial = torch.randn(rows, NUM_TOKENS, cfg.d_model,
                                  generator=gen, device=cuda)
            mod = torch.randn(rows, 6 * cfg.d_model, generator=gen,
                              device=cuda)
            reduce_ms = cuda_ms(lambda: sharded.model_sum("blocks/wo",
                                                          partial))
            ada_ms = cuda_ms(lambda: sharded.model_cat("blocks/ada", mod))
        print(f"phase 11 (a) DiT-XL call at {rows} x {NUM_TOKENS} tokens, "
              f"TF32: host tree {host_ms} ms, TP blocks on the (1, 1) mesh "
              f"{tp_ms} ms (CUDA events, median); its NCCL all-reduce of a "
              f"{partial.numel() * 4} B partial {reduce_ms} ms (x {2 * L} a "
              f"call), the adaLN all-gather {ada_ms} ms (x {L + 1}), no "
              f"FSDP all-gather (one data rank); phase 10 (a): window "
              f"all-gather {phase10 and phase10.get('gather_ms')} ms, poll "
              f"all-reduce {phase10 and phase10.get('reduce_ms')} ms")
        out.update(dit_ms=dict(host=host_ms, tp=tp_ms), reduce_ms=reduce_ms,
                   ada_gather_ms=ada_ms)
        del sharded, partial, mod, x
    finally:
        write_settings(before)
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    del params
    free_card()
    out["dryrun"] = production_dryrun()
    out["gloo"] = tp_on_gloo()
    return out


def production_dryrun():
    """Phase 11 (b): the dry-run's ParaTAA cell on the production meshes,
    in a subprocess (a fake world of 256, and one of 512 ranks), at full
    width."""
    import os
    import shutil

    out_dir = ROOT / "build" / "chip_smoke_dryrun_mesh"
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--parataa",
         "--mesh", "both", "--out", str(out_dir)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"phase 11 (b): dry-run failed: {proc.stderr[-2000:]}")
    recs = {}
    for label in ("single", "multi"):
        rec = json.loads((out_dir / f"dit-xl__parataa_serve__{label}.json")
                         .read_text())
        print(f"phase 11 (b) dry-run --mesh {label} (modeled, rank 0 of "
              f"{rec.get('chips')}): status {rec['status']}, {rec.get('placement')}, "
              f"{rec.get('n_samples')} requests, per chip "
              f"{rec.get('flops_per_chip')} flop, {rec.get('bytes_per_chip')} B, "
              f"peak {rec.get('peak_bytes')} B (fits_hbm "
              f"{rec.get('fits_hbm')}); collectives "
              f"{rec.get('collective_breakdown')} B, by link "
              f"{rec.get('collective_by_link')}; compute "
              f"{rec.get('compute_s')} s (TF32 {rec.get('compute_s_tf32')}), "
              f"memory {rec.get('memory_s')} s, collective "
              f"{rec.get('collective_s')} s -> {rec.get('dominant')}; "
              f"model_flops_ratio {rec.get('model_flops_ratio')}")
        check(rec["status"] == "ok" and rec["collective_bytes_per_chip"] > 0
              and "peak_bytes" in rec and "fits_hbm" in rec,
              f"phase 11 (b): {label} record {rec.get('status')}")
        recs[label] = {k: rec[k] for k in (
            "chips", "flops_per_chip", "peak_bytes", "fits_hbm",
            "collective_breakdown", "collective_by_link", "compute_s",
            "compute_s_tf32", "memory_s", "collective_s", "dominant",
            "model_flops_ratio")}
    check((recs["single"]["chips"], recs["multi"]["chips"]) == (256, 512),
          f"phase 11 (b): chips {recs}")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 11 (b) in {time.monotonic() - t0} s")
    return recs


def tp_on_gloo():
    """Phase 11 (c): two processes on the one card, a gloo group
    (``init_distributed("cpu")``: gloo takes the CUDA tensors of every
    collective the TP DiT issues), ``debug`` with data 1 x model 2, each
    rank computing its 8 heads' columns of DiT-XL (full width,
    TP_GLOO_LAYERS of its layers):
    eps and ``run_batch`` against the host placement in each rank,
    float32 (TF32 off)."""
    import os
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_gloo_"))
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-gloo-rank",
         str(r), str(work)], cwd=ROOT, env=dict(os.environ),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    check(all(p.returncode == 0 for p in procs),
          f"phase 11 (c): a rank failed: {[log[-2000:] for log in logs]}")
    outs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    for r, o in enumerate(outs):
        m = o["fused"]
        print(f"phase 11 (c) gloo rank {r} of 2 on the one card, "
              f"{o['describe']}, DiT-XL width at {o['wq'][0]} layers: wq "
              f"block {o['wq']}; eps rel err vs the "
              f"host tree {o['eps_rel']}; run_batch fused ({o['tokens']} "
              f"tokens, T={T_STEPS}, float32) trajectories rel err "
              f"{m['rel']}, iters {m['iters']} (host {m['host_iters']}), "
              f"nfe equal {m['same_nfe']}; collectives {m['comm']}; walls "
              f"s host / TP {m['walls']}")
        check(o["eps_rel"] < 1e-5, f"phase 11 (c): eps {o['eps_rel']}")
        check(m["rel"] < 1e-4 and m["iters"] == m["host_iters"]
              and m["same_nfe"], f"phase 11 (c): {m}")
    print(f"phase 11 (c) in {time.monotonic() - t0} s")
    return outs


def tp_gloo_rank(rank: int, work: Path) -> None:
    """One rank of phase 11 (c) (``chip_smoke.py --tp-gloo-rank R DIR``)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.diffusion import dit
    from repro_torch.diffusion.convert import ADA_ZERO
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models.pdefs import init_on_device
    from repro_torch.sampling import Placement, SampleRequest

    cuda = torch.device("cuda")
    torch.cuda.set_device(0)
    init_distributed("cpu", world_size=2, rank=rank,
                     init_method=f"file://{work}/store", timeout_s=300)
    # gloo groups; the tensors live on the card
    plc = Placement.for_mesh(make_mesh("debug", data_parallel=1,
                                       model_parallel=2, device_type="cpu"))
    cfg = dataclasses.replace(get_arch("dit-xl"), num_layers=TP_GLOO_LAYERS)
    params = init_on_device(dit.dit_defs(cfg), SEED, cuda)
    gen = torch.Generator(device=cuda).manual_seed(SEED + 1)
    for name in ADA_ZERO:
        leaf = params["blocks"][name] if name == "ada" else params[name]
        leaf.normal_(0.0, ADA_SCALE, generator=gen)
    defs = dit.dit_defs(cfg)
    rows = REQUESTS * T_STEPS
    x = torch.randn(rows, TP_GLOO_TOKENS, cfg.latent_dim, generator=gen,
                    device=cuda)
    t = torch.linspace(10.0, 990.0, rows, device=cuda)
    y = torch.arange(rows, device=cuda) % cfg.num_classes
    sharded = plc.shard_params(params, defs)
    with torch.inference_mode():
        want = dit.dit_apply(params, cfg, x, t, y)
        got = dit.dit_apply(sharded, cfg, x, t, y)
    eps_rel = float((got - want).norm() / want.norm())
    rng = np.random.default_rng(SEED)
    requests = [SampleRequest(label=int(rng.integers(0, cfg.num_classes)),
                              seed=int(rng.integers(1 << 30)))
                for _ in range(REQUESTS)]
    runs = tp_engine_runs(cfg, params, plc, requests,
                          num_tokens=TP_GLOO_TOKENS, defs=defs, strict=False,
                          modes=("fused",))
    res = {"describe": plc.describe(True),
           "wq": list(sharded["blocks"]["wq"].shape), "eps_rel": eps_rel,
           "tokens": TP_GLOO_TOKENS}
    for mode, r in runs.items():
        host, tp = r["host"], r["tp"]
        res[mode] = dict(
            rel=rel_traj(tp["results"], host["results"]), iters=tp["iters"],
            host_iters=host["iters"],
            same_nfe=[a.nfe for a in tp["results"]]
            == [b.nfe for b in host["results"]],
            comm=tp["comm"], walls=[host["wall_s"], tp["wall_s"]])
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


# --- phase 12: the LM backbones tensor-parallel over model -----------------

#: prefill batch x tokens and decode steps of (a) and (b)
TP_LM_BATCH, TP_LM_PROMPT, TP_LM_DECODE = 2, 512, 8
#: (b)'s models on two gloo ranks: arch -> layers (the depth cut; widths
#: are the published ones; qwen3-0.6b at half its 28, the cut that keeps
#: the script inside its time limit)
TP_LM_ARCHS = {"qwen3-0.6b": 14, "recurrentgemma-2b": 3, "mamba2-1.3b": 2,
               "qwen2-moe-a2.7b": 2}


def lm_tp_calls(cfg, params, cache, tokens, *, events: bool) -> dict:
    """Prefill ``tokens[:, :TP_LM_PROMPT]`` (last position), then decode
    the rest one token at a time on ``params`` (the whole tree, or a
    rank's ``ShardedParams`` with its ``ShardedCache``): each call's
    logits, collectives (``comm``, from 0) and ms (CUDA events, or host
    wall after a synchronize where gloo blocks the host)."""
    import torch

    from repro_torch import comm
    from repro_torch.models import backbone as B

    kinds = ("all-gather", "all-reduce", "reduce-scatter")

    def timed(fn):
        if events:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.monotonic() - t0) * 1e3

    out = {"logits": [], "counts": [], "ms": []}
    with torch.inference_mode():
        for t in range(TP_LM_PROMPT - 1, tokens.shape[1]):
            comm.reset()
            if t == TP_LM_PROMPT - 1:
                (logits, _), ms = timed(lambda: B.prefill(
                    params, cfg, tokens[:, :TP_LM_PROMPT], cache))
            else:
                (logits, _), ms = timed(lambda: B.decode_step(
                    params, cfg, tokens[:, t:t + 1], cache))
            out["logits"].append(logits.float())
            out["counts"].append({k: comm.counts[k] for k in kinds})
            out["ms"].append(ms)
    return out


def lm_tp_pair(cfg, params, tp, mesh, tokens, *, events: bool) -> dict:
    """:func:`lm_tp_calls` on the whole tree and on the rank's blocks (a
    warm-up of each first), each on a fresh cache."""
    import torch

    from repro_torch.launch import steps as S
    from repro_torch.models import backbone as B

    n = tokens.shape[1]
    cuda = torch.device("cuda")

    def host_cache():
        return B.init_cache(cfg, TP_LM_BATCH, n, torch.float32, cuda)

    def tp_cache():
        return S.local_cache(cfg, TP_LM_BATCH, n, mesh, torch.float32, cuda)

    for p, make in ((params, host_cache), (tp, tp_cache)):
        lm_tp_calls(cfg, p, make(), tokens, events=events)     # warm-up
    return {"host": lm_tp_calls(cfg, params, host_cache(), tokens,
                                events=events),
            "tp": lm_tp_calls(cfg, tp, tp_cache(), tokens, events=events)}


def lm_tp_summary(cfg, pair, model: int) -> dict:
    """Errors, collectives against ``backbone.tp_collectives`` and ms of a
    :func:`lm_tp_pair`."""
    import torch

    from repro_torch.models.backbone import tp_collectives

    host, tp = pair["host"], pair["tp"]
    n = TP_LM_PROMPT + TP_LM_DECODE
    cap = min(cfg.window_size, n) if cfg.window_size else n
    want = [tp_collectives(cfg, "prefill", model, 1, TP_LM_PROMPT, cap)] + \
        [tp_collectives(cfg, "decode", model, 1, 1, cap)] * TP_LM_DECODE
    rels = [float((a - b).norm() / b.norm())
            for a, b in zip(tp["logits"], host["logits"])]
    return dict(
        prefill_rel=rels[0], decode_rel=max(rels[1:]),
        bitwise=all(torch.equal(a, b) for a, b in zip(tp["logits"],
                                                      host["logits"])),
        counts=tp["counts"][:2], counts_ok=tp["counts"] == want,
        want=want[:2], prefill_ms=[host["ms"][0], tp["ms"][0]],
        decode_ms=[statistics.mean(host["ms"][1:]),
                   statistics.mean(tp["ms"][1:])])


def lm_wrapper_engines(cfg, params, placement, modes, *, strict=True):
    """The wrapper of ``cfg`` as eps_theta through ``SamplingEngine``
    (phase 7's geometry: latent 8, 16 tokens, T=50, one request): the
    host placement, then ``placement`` with ``param_defs=wrapper_defs``,
    for each round mode; K1-K3 launches counted from 0 just before each
    run.  Returns {mode: {label: run}}."""
    from repro_torch.core import ddim_coeffs
    from repro_torch.diffusion import dit
    from repro_torch.sampling import (SampleRequest, SamplingEngine,
                                      get_sampler)

    device = params["in_proj"].device
    out = {}
    for mode in modes:
        spec = get_sampler("taa", fuse_round=mode == "fused")
        for label, plc, defs in (("host", None, None), (
                "tp", placement, dit.wrapper_defs(cfg, WRAP_LATENT))):
            engine = SamplingEngine(
                lambda p, x, taus, y: dit.wrapper_apply(p, cfg, x, taus),
                params, ddim_coeffs(WRAP_T), spec,
                sample_shape=(WRAP_TOKENS, WRAP_LATENT), device=device,
                placement=plc, param_defs=defs)
            if strict:
                strict_solves(engine)
            reset_all_launches()
            t0 = time.monotonic()
            res = engine.run_batch([SampleRequest(label=0, seed=SEED)],
                                   batch_size=1)
            wall = time.monotonic() - t0
            d = engine.last_dispatches[0]
            out.setdefault(mode, {})[label] = dict(
                results=res, wall_s=wall, launches=all_launches(),
                iters=d["device_iters"], polls=d["blocking_polls"],
                sharded=engine.denoiser_sharded)
    return out


def wrapper_weights(cfg, device):
    """phase 7's wrapper tree drawn on ``device`` (seed ``SEED``, out_proj
    N(0, WRAP_OUT_SCALE^2))."""
    import torch

    from repro_torch.diffusion import dit
    from repro_torch.models.pdefs import init_on_device

    params = init_on_device(dit.wrapper_defs(cfg, WRAP_LATENT), SEED, device,
                            torch.float32)
    params["out_proj"].normal_(0.0, WRAP_OUT_SCALE, generator=torch.Generator(
        device=device).manual_seed(SEED + 1))
    return params


def lm_tensor_parallel_path():
    """Phase 12: the LM backbones tensor-parallel over ``model``.  (a) a
    world of one over NCCL on a (1, 1) ``debug`` mesh: qwen3-0.6b at full
    width and depth, float32 (TF32 off): prefill 2 x 512 and 8 decode
    steps on the rank's ``ShardedParams``/``ShardedCache`` bit for bit the
    host path's, the collectives by ``backbone.tp_collectives``; the
    wrapper engine (``param_defs=wrapper_defs``) staged and fused bit for
    bit the host placement's, with equal iters, nfe, polls and K1-K3
    launches; ms host / TP.  (b) two gloo ranks on the one card, model 2
    (:func:`tp_lm_on_gloo`).  (c) the dry-run's LM prefill and decode
    cells on pod and multi-pod (modeled) run beside phase 13 (c) and the
    kernels' build (:func:`start_production_dryruns`): on the host's
    cores, with no timing beside them."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import backbone as B
    from repro_torch.models.convert import backbone_init_on_device
    from repro_torch.models.shardctx import ShardedParams
    from repro_torch.sampling import Placement

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    rdv = tempfile.mkdtemp(prefix="chip_smoke_rdv_")
    backend = init_distributed("cuda", world_size=1, rank=0,
                               init_method=f"file://{rdv}/store",
                               timeout_s=300)
    check(backend == "nccl", f"phase 12: backend {backend}")
    out = {}
    try:
        mesh = make_mesh("debug", data_parallel=1, model_parallel=1,
                         device_type="cuda")
        cfg = get_arch("qwen3-0.6b")
        params = backbone_init_on_device(cfg, SEED, cuda, dtype=torch.float32)
        tp = ShardedParams.build(params, B.build_defs(cfg), mesh)
        gen = torch.Generator(device=cuda).manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (
            TP_LM_BATCH, TP_LM_PROMPT + TP_LM_DECODE), generator=gen,
            device=cuda)
        summ = lm_tp_summary(cfg, lm_tp_pair(cfg, params, tp, mesh, tokens,
                                             events=True), 1)
        print(f"phase 12 (a) qwen3-0.6b ({cfg.num_layers} layers, float32) "
              f"on the (1, 1) "
              f"mesh over NCCL: prefill {TP_LM_BATCH} x {TP_LM_PROMPT} + "
              f"{TP_LM_DECODE} decodes bit for bit the host path "
              f"{summ['bitwise']}; collectives a prefill / decode "
              f"{summ['counts']} (formula {summ['want']}); prefill ms host "
              f"/ TP {summ['prefill_ms']}, decode ms a token "
              f"{summ['decode_ms']} (CUDA events)")
        check(summ["bitwise"] and summ["counts_ok"], f"phase 12 (a): {summ}")
        out["lm"] = summ
        del params, tp
        free_card()
        wparams = wrapper_weights(cfg, cuda)
        plc = Placement.for_mesh(mesh)
        runs = lm_wrapper_engines(cfg, wparams, plc, ("fused", "staged"))
        for mode, r in runs.items():
            host, tpr = r["host"], r["tp"]
            k13 = {k: tpr["launches"].get(k, 0) for k in (
                "taa_gram", "taa_apply", "taa_round")}
            print(f"phase 12 (a) wrapper engine {mode} on "
                  f"{plc.describe(True)}: iters host {host['iters']} / TP "
                  f"{tpr['iters']}, nfe {[x.nfe for x in host['results']]} /"
                  f" {[x.nfe for x in tpr['results']]}, polls "
                  f"{host['polls']} / {tpr['polls']}, K1-K3 launches {k13}; "
                  f"walls s host {host['wall_s']}, TP {tpr['wall_s']}")
            check(tpr["sharded"] and same_results(tpr["results"],
                                                  host["results"]),
                  f"phase 12 (a) {mode}: TP wrapper not bit for bit")
            check(tpr["launches"] == host["launches"]
                  and tpr["polls"] == host["polls"]
                  and tpr["iters"] == host["iters"],
                  f"phase 12 (a) {mode}: launches/polls/iters differ")
            want = {"taa_round": tpr["iters"]} if mode == "fused" else \
                {"taa_gram": tpr["iters"], "taa_apply": tpr["iters"]}
            check(all(k13[k] == v for k, v in want.items()),
                  f"phase 12 (a) {mode}: K1-K3 launches {k13}")
            out[mode] = dict(iters=tpr["iters"], launches=k13,
                             walls=[host["wall_s"], tpr["wall_s"]])
        del wparams
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    free_card()
    out["gloo"] = tp_lm_on_gloo()
    return out


def tp_lm_on_gloo():
    """Phase 12 (b): two processes on the one card in a gloo group,
    ``debug`` with data 1 x model 2, float32 at full width (TP_LM_ARCHS'
    depths): each model's prefill (2 x 512) and 8 decodes on the rank's
    blocks against the whole tree in each rank, within 1e-5 relative of
    the logits, collectives by the formula, prefill and decode ms host /
    TP; then qwen3-0.6b's wrapper engine (fused): iters and nfe equal,
    trajectories within 1e-4."""
    import os
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_lm_"))
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-lm-gloo-rank",
         str(r), str(work)], cwd=ROOT, env=dict(os.environ),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    check(all(p.returncode == 0 for p in procs),
          f"phase 12 (b): a rank failed: {[log[-3000:] for log in logs]}")
    outs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    for r, o in enumerate(outs):
        for arch, m in o["lm"].items():
            print(f"phase 12 (b) gloo rank {r} of 2, model 2, {arch} "
                  f"({m['layers']} layers, float32): prefill logits rel err "
                  f"{m['prefill_rel']}, decode {m['decode_rel']}; "
                  f"collectives a prefill / decode {m['counts']} (formula "
                  f"{m['want']}); prefill ms host / TP {m['prefill_ms']}, "
                  f"decode ms a token {m['decode_ms']} (host wall)")
            check(m["prefill_rel"] < 1e-5 and m["decode_rel"] < 1e-5
                  and m["counts_ok"], f"phase 12 (b) {arch}: {m}")
        w = o["wrapper"]
        print(f"phase 12 (b) gloo rank {r}: qwen3-0.6b wrapper engine fused "
              f"({WRAP_TOKENS} tokens, T={WRAP_T}): trajectories rel err "
              f"{w['rel']}, iters {w['iters']} (host {w['host_iters']}), "
              f"nfe equal {w['same_nfe']}; walls s host / TP {w['walls']}")
        check(w["rel"] < 1e-4 and w["iters"] == w["host_iters"]
              and w["same_nfe"], f"phase 12 (b) wrapper: {w}")
    print(f"phase 12 (b) in {time.monotonic() - t0} s")
    return outs


def tp_lm_gloo_rank(rank: int, work: Path) -> None:
    """One rank of phase 12 (b) (``chip_smoke.py --tp-lm-gloo-rank R
    DIR``)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import backbone as B
    from repro_torch.models.convert import backbone_init_on_device
    from repro_torch.models.shardctx import ShardedParams
    from repro_torch.sampling import Placement

    cuda = torch.device("cuda")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cpu", world_size=2, rank=rank,
                     init_method=f"file://{work}/store", timeout_s=300)
    # gloo groups; the tensors live on the card
    mesh = make_mesh("debug", data_parallel=1, model_parallel=2,
                     device_type="cpu")
    res = {"lm": {}}
    for arch, layers in TP_LM_ARCHS.items():
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        params = backbone_init_on_device(cfg, SEED, cuda, dtype=torch.float32)
        tp = ShardedParams.build(params, B.build_defs(cfg), mesh)
        gen = torch.Generator(device=cuda).manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (
            TP_LM_BATCH, TP_LM_PROMPT + TP_LM_DECODE), generator=gen,
            device=cuda)
        summ = lm_tp_summary(cfg, lm_tp_pair(cfg, params, tp, mesh, tokens,
                                             events=False), 2)
        summ.pop("bitwise")
        res["lm"][arch] = dict(summ, layers=layers)
        del params, tp
        torch.cuda.empty_cache()
    cfg = get_arch("qwen3-0.6b")
    wparams = wrapper_weights(cfg, cuda)
    runs = lm_wrapper_engines(cfg, wparams, Placement.for_mesh(mesh),
                              ("fused",), strict=False)
    host, tpr = runs["fused"]["host"], runs["fused"]["tp"]
    res["wrapper"] = dict(
        rel=rel_traj(tpr["results"], host["results"]), iters=tpr["iters"],
        host_iters=host["iters"],
        same_nfe=[a.nfe for a in tpr["results"]]
        == [b.nfe for b in host["results"]],
        walls=[host["wall_s"], tpr["wall_s"]])
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


# --- phase 13: the tensor-parallel train step over (data, model) -----------

#: (a)'s and (b)'s steps, and the microbatches of every step
TP_TRAIN_STEPS_A, TP_TRAIN_STEPS_B, TP_TRAIN_GA = 3, 2, 2
#: the DiT's batch x latent tokens (phase 6's) and an LM's batch x tokens
#: (phase 7's train batch)
TP_TRAIN_DIT, TP_TRAIN_LM = (16, 16), (8, 128)
#: (b)'s models on two gloo ranks: arch -> layers (the depth cut; widths
#: are the published ones)
TP_TRAIN_ARCHS = {"dit-xl": 4, "qwen3-0.6b": 2, "mamba2-1.3b": 2,
                  "recurrentgemma-2b": 3, "qwen2-moe-a2.7b": 2}
#: the adaLN leaves, held at 5e-5 in (b) (tests/test_torch_train.py)
ADA_LEAVES = ("ada", "final_ada")
#: (b)'s first-step gradients are held within this fraction of their
#: leaf's largest gradient entry
GRAD_TOL = 1e-5
#: (b): the most elements, as a share of the model's, whose gradient's
#: sign at a step differs between TP and host (Adam moves an element by
#: about lr x that sign, so such an element is held within 2 x the steps'
#: learning rates instead of GRAD_TOL's rule)
FLIP_SHARE = 1e-4
#: the LM leaves initialized to zeros or ones, moved off their inits
#: (tests/test_torch_tp_lm.py): a zero leaf whose gradient is 0 (a key
#: bias under softmax) takes Adam steps of its gradient's rounding noise
CONSTANT_LEAVES = ("bq", "bk", "bv", "scale", "A_log", "dt_bias", "D",
                   "b_a", "b_i")


def tp_train_weights(cfg, device):
    """Weights drawn on ``device`` from ``SEED``; the DiT's adaLN-zero
    leaves and ``out_proj`` N(0, ADA_SCALE^2), so that every block's
    gradient is live at the first step, and an LM's constant leaves plus
    N(0, 0.1^2)."""
    import torch

    from repro_torch.diffusion import dit
    from repro_torch.models import backbone as B
    from repro_torch.models.pdefs import get_path, init_on_device, walk

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    if not cfg.is_diffusion:
        defs = B.build_defs(cfg)
        params = init_on_device(defs, SEED, device, torch.float32)
        for path, _ in walk(defs):
            if path[-1] in CONSTANT_LEAVES:
                leaf = get_path(params, path)
                leaf.add_(torch.randn(leaf.shape, generator=gen,
                                      device=device), alpha=0.1)
        return params
    params = init_on_device(dit.dit_defs(cfg), SEED, device, torch.float32)
    for leaf in (params["blocks"]["ada"], params["final_ada"],
                 params["out_proj"]):
        leaf.normal_(0.0, ADA_SCALE, generator=gen)
    return params


def tp_train_batches(cfg, steps: int, device) -> list:
    """``steps`` global train batches drawn on ``device`` from ``SEED``
    (the same on every rank)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    out = []
    for _ in range(steps):
        if cfg.is_diffusion:
            b, n = TP_TRAIN_DIT
            shape = (b, n, cfg.latent_dim)
            out.append({
                "latents": torch.randn(shape, generator=gen, device=device),
                "noise": torch.randn(shape, generator=gen, device=device),
                "t": torch.randint(0, 1000, (b,), generator=gen,
                                   device=device, dtype=torch.int32),
                "labels": torch.randint(0, cfg.num_classes, (b,),
                                        generator=gen, device=device,
                                        dtype=torch.int32)})
        else:
            b, s = TP_TRAIN_LM
            out.append({k: torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device=device)
                        for k in ("inputs", "labels")})
    return out


def tp_train_formula(cfg, model: int, data: int) -> dict:
    from repro_torch.diffusion import dit
    from repro_torch.models import backbone as B

    if cfg.is_diffusion:
        return dit.tp_train_collectives(cfg, model, data, TP_TRAIN_GA)
    return B.tp_train_collectives(cfg, model, data, TP_TRAIN_LM[1],
                                  TP_TRAIN_GA)


def tp_train_steps(cfg, params, batches, *, mesh=None, events=True,
                   keep=None) -> dict:
    """``launch.steps.make_train_step(cfg, grad_accum=TP_TRAIN_GA)`` over
    ``batches`` on ``params`` (the whole tree), or with ``mesh`` on its
    ``ShardedParams`` (the rank's rows of each batch, ``local_batch``):
    each step's loss, grad norm, collectives and ms (CUDA events, or host
    wall after a synchronize where gloo blocks the host), and the card's
    allocation peak above what was live before the step.  ``keep``, when
    given, is called in each step with the gradients AdamW takes (the
    synced tree of the rank's blocks on a mesh) and the step's index; what
    it returns is listed under ``grads``."""
    import torch

    from repro_torch import comm
    from repro_torch.diffusion import dit
    from repro_torch.launch import steps as S
    from repro_torch.models import backbone as B
    from repro_torch.models.shardctx import ShardedParams
    from repro_torch.optim import adamw_init

    if mesh is not None:
        defs = dit.dit_defs(cfg) if cfg.is_diffusion else B.build_defs(cfg)
        params = ShardedParams.build(params, defs, mesh)
    opt = adamw_init(params.local if mesh is not None else params)
    step = S.make_train_step(cfg, grad_accum=TP_TRAIN_GA)
    kinds = ("all-gather", "all-reduce", "reduce-scatter")
    out = {"loss": [], "grad_norm": [], "counts": [], "ms": [], "peak": [],
           "grads": []}
    update = S.adamw_update

    def kept(grads, *args, **kw):
        out["grads"].append(keep(grads, len(out["grads"])))
        return update(grads, *args, **kw)
    if keep is not None:
        S.adamw_update = kept
    try:
        for i, batch in enumerate(batches):
            if mesh is not None:
                batch = S.local_batch(batch, mesh, TP_TRAIN_GA)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            comm.reset()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.monotonic()
            start.record()
            params, opt, m = step(params, opt, batch, torch.tensor(
                i, dtype=torch.int32, device=batch[next(iter(batch))]
                .device))
            end.record()
            torch.cuda.synchronize()
            out["ms"].append(start.elapsed_time(end) if events
                             else (time.monotonic() - t0) * 1e3)
            out["peak"].append(torch.cuda.max_memory_allocated() - base)
            out["counts"].append({k: comm.counts[k] for k in kinds})
            out["loss"].append(m["loss"].item())
            out["grad_norm"].append(m["grad_norm"].item())
            out["lr_sum"] = out.get("lr_sum", 0.0) + m["lr"].item()
    finally:
        S.adamw_update = update
    del opt
    out["params"] = params
    return out


def dryrun_train_peak(cfg, batch) -> dict:
    """The dry-run's memory count (``launch.dryrun._memory``: arguments +
    temporaries on ``meta``) of the host train step over ``batch``'s
    shapes, float32: what the TP step at one rank holds too."""
    import torch

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S

    meta = torch.device("meta")
    params, opt = S.abstract_model_state(cfg, dtype=torch.float32,
                                         device=meta)
    args = (params, opt, {k: torch.empty(v.shape, dtype=v.dtype, device=meta)
                          for k, v in batch.items()},
            torch.zeros((), dtype=torch.int32, device=meta))
    with torch.enable_grad():
        return D._memory(S.make_train_step(cfg, grad_accum=TP_TRAIN_GA),
                         args)


def tp_train_path():
    """Phase 13: the tensor-parallel train step (``launch.steps.
    make_train_step`` on a rank's ``ShardedParams``).  (a) a world of one
    over NCCL on a (1, 1) ``debug`` mesh, float32 with TF32 off and
    deterministic algorithms (the index backward of the DiT's class
    embedding and of the LM's token embedding otherwise adds with atomics,
    in another order a run): DiT-XL (28 layers, batch 16 x 16 tokens) and
    qwen3-0.6b (28 layers, batch 8 x 128) at full width and depth, 3
    steps of grad_accum 2 each, the host step against the TP step:
    losses, grad norms and every param leaf bit for bit, collectives a
    step by the formula, step ms host / TP (CUDA events), the TP step's
    allocation peak against the dry-run's count of the same step; no
    kernel of the port launched.  (b) two gloo ranks on the one card,
    model 2 (:func:`tp_train_on_gloo`).  (c) the dry-run's train_4k cells
    of dit-xl and qwen3-0.6b on pod and multi-pod (modeled) run beside
    phase 12 (c) and the build (:func:`start_production_dryruns`)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    rdv = tempfile.mkdtemp(prefix="chip_smoke_rdv_")
    backend = init_distributed("cuda", world_size=1, rank=0,
                               init_method=f"file://{rdv}/store",
                               timeout_s=300)
    check(backend == "nccl", f"phase 13: backend {backend}")
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_mesh("debug", data_parallel=1, model_parallel=1,
                         device_type="cuda")
        for arch in ("dit-xl", "qwen3-0.6b"):
            cfg = get_arch(arch)
            batches = tp_train_batches(cfg, TP_TRAIN_STEPS_A, cuda)
            reset_all_launches()
            host = tp_train_steps(cfg, tp_train_weights(cfg, cuda), batches)
            free_card()
            tp = tp_train_steps(cfg, tp_train_weights(cfg, cuda), batches,
                                mesh=mesh)
            launches = {k: v for k, v in all_launches().items() if v}
            same = [torch.equal(a, b) for a, b in zip(
                leaves(tp["params"].local), leaves(host["params"]))]
            want = tp_train_formula(cfg, 1, 1)
            mem = dryrun_train_peak(cfg, batches[0])
            unit = "batch 16 x 16 tokens" if cfg.is_diffusion else \
                "batch 8 x 128"
            print(f"phase 13 (a) {arch} ({cfg.num_layers} layers, float32, "
                  f"{unit}, grad_accum {TP_TRAIN_GA}) on the (1, 1) mesh "
                  f"over NCCL: losses host {host['loss']} / TP "
                  f"{tp['loss']}, grad norms {host['grad_norm']} / "
                  f"{tp['grad_norm']}, {sum(same)} of {len(same)} leaves "
                  f"bit for bit; collectives a step {tp['counts'][0]} "
                  f"(formula {want}); step ms host {host['ms']} / TP "
                  f"{tp['ms']} (CUDA events); TP step peak above its "
                  f"start {tp['peak']} B, dry-run temporaries "
                  f"{mem['temp_bytes']} B (arguments {mem['argument_bytes']}"
                  f" B); port kernels launched {launches}")
            check(host["loss"] == tp["loss"]
                  and host["grad_norm"] == tp["grad_norm"] and all(same),
                  f"phase 13 (a) {arch}: the TP step is not the host's")
            check(all(c == want for c in tp["counts"]),
                  f"phase 13 (a) {arch}: collectives {tp['counts']}")
            check(not launches, f"phase 13 (a): launches {launches}")
            out[arch] = dict(losses=tp["loss"], ms=[host["ms"], tp["ms"]],
                             counts=tp["counts"][0], peak=tp["peak"],
                             dryrun=mem)
            del host, tp
            free_card()
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    free_card()
    out["gloo"] = tp_train_on_gloo()
    return out


def tp_train_on_gloo():
    """Phase 13 (b): two processes on the one card in a gloo group
    (``chip_smoke.py --tp-train-gloo-rank R DIR``), ``debug`` with data 1
    x model 2, float32 (deterministic algorithms, as (a)), published
    widths at TP_TRAIN_ARCHS' depths: 2 train steps of grad_accum 2 on
    the rank's blocks against the host step in each rank (run one rank at
    a time): losses and grad norms within 1e-5 relative, each block
    within 1e-5 of its leaf's largest entry (5e-5 for the adaLN leaves),
    the first batch's gradients of each block within 1e-5 of its leaf's
    largest gradient entry, collectives a step by the formula; step ms
    host / TP (host wall, each step's gradients copied for the check
    inside it).  Adam moves an element by about lr x the sign of its
    gradient: an element whose gradient's sign at a step is not the host
    step's (a rounding-level gradient) is held within 2 x the steps'
    summed learning rates instead, and such elements are counted and at
    most FLIP_SHARE of the model's."""
    import os
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_train_"))
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-train-gloo-rank",
         str(r), str(work)], cwd=ROOT, env=dict(os.environ),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    check(all(p.returncode == 0 for p in procs),
          f"phase 13 (b): a rank failed: {[log[-3000:] for log in logs]}")
    outs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    for r, o in enumerate(outs):
        for arch, m in o.items():
            worst = max(m["params"].items(), key=lambda kv: kv[1])
            gworst = max(m["grads"].items(), key=lambda kv: kv[1])
            fworst = max(m["flip_errs"].items(), key=lambda kv: kv[1])
            print(f"phase 13 (b) gloo rank {r} of 2, model 2, {arch} "
                  f"({m['layers']} layers, float32): losses rel err "
                  f"{m['loss']}, grad norms {m['grad_norm']}; first-step "
                  f"gradients' largest block err {gworst[1]} ({gworst[0]})"
                  f" of the leaf's largest gradient entry; params' largest "
                  f"block err {worst[1]} ({worst[0]}) of the leaf's "
                  f"largest entry where the gradients' signs agree; "
                  f"{m['n_flipped']} of {m['n_elements']} elements "
                  f"(most in {m['most_flipped'][0]}: "
                  f"{m['most_flipped'][1]}) whose gradient's sign differs "
                  f"at a step: largest |diff| {fworst[1]} ({fworst[0]}) "
                  f"against 2 x the steps' lr {2 * m['lr_sum']}; the "
                  f"largest diff of "
                  f"all at {m['worst']}; collectives a step {m['counts']} "
                  f"(formula {m['want']}); step ms host {m['ms'][0]} / TP "
                  f"{m['ms'][1]} (host wall)")
            bad = {k: e for k, e in m["params"].items()
                   if e >= (5e-5 if k.split("/")[-1] in ADA_LEAVES
                            else 1e-5)}
            check(max(m["loss"]) < 1e-5 and max(m["grad_norm"]) < 1e-5
                  and gworst[1] < GRAD_TOL and not bad
                  and fworst[1] <= 2 * m["lr_sum"]
                  and m["n_flipped"] <= FLIP_SHARE * m["n_elements"]
                  and m["counts_ok"],
                  f"phase 13 (b) {arch}: {m['loss']} {m['grad_norm']} "
                  f"{gworst} {bad} {fworst} {m['n_flipped']} "
                  f"{m['counts']}")
    print(f"phase 13 (b) in {time.monotonic() - t0} s")
    return outs


def tp_train_gloo_rank(rank: int, work: Path) -> None:
    """One rank of phase 13 (b) (``chip_smoke.py --tp-train-gloo-rank R
    DIR``).  The host steps run one rank at a time, and each keeps only
    the rank's blocks of their params and gradients."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.diffusion import dit
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import backbone as B
    from repro_torch.models import pdefs
    from repro_torch.models.shardctx import ShardedParams
    from repro_torch.tree import flatten_with_paths, path_name

    cuda = torch.device("cuda")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # as (a): the MoE dispatch's and an embedding's index backward add
    # with atomics otherwise, in another order a run
    torch.use_deterministic_algorithms(True, warn_only=True)
    init_distributed("cpu", world_size=2, rank=rank,
                     init_method=f"file://{work}/store", timeout_s=300)
    # gloo groups; the tensors live on the card
    mesh = make_mesh("debug", data_parallel=1, model_parallel=2,
                     device_type="cpu")
    res = {}
    for arch, layers in TP_TRAIN_ARCHS.items():
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        defs = dit.dit_defs(cfg) if cfg.is_diffusion else B.build_defs(cfg)
        specs = {path_name(p): pdefs.resolve_spec(spec, mesh)
                 for p, spec in pdefs.walk(defs)}
        layouts = {path_name(p): spec.layout for p, spec in pdefs.walk(defs)}
        batches = tp_train_batches(cfg, TP_TRAIN_STEPS_B, cuda)

        def blocks(tree):
            """(this rank's block, the whole leaf's largest |entry|) of
            every leaf."""
            return {path_name(p): (pdefs.local_block(
                x, specs[path_name(p)], mesh, layouts[path_name(p)]).clone(),
                float(x.abs().max())) for p, x in flatten_with_paths(tree)}

        def errs(got, want, where=None):
            """leaf -> (largest |diff| of ``got``'s block over the whole
            leaf's largest |entry|, where it is); with ``where`` (leaf ->
            a bool mask) only over the masked elements.  float32 leaves:
            the difference of two close values is exact."""
            out = {}
            for k, x in got.items():
                block, top = want[k]
                diff = (x - block).abs()
                if where is not None:
                    diff = diff.where(where[k], 0.0)
                out[k] = (float(diff.max()) / max(top, 1e-30),
                          int(diff.argmax()))
                del diff
            return out

        def named(tree):
            return {path_name(p): x for p, x in flatten_with_paths(tree)}

        def sign(x):
            return torch.sign(x).to(torch.int8)

        def keep_host(grads, i):
            """The host's gradients of a step as the rank's blocks: the
            first step's values, the second's signs."""
            got = blocks(grads)
            return got if i == 0 else {k: sign(g) for k, (g, _) in
                                       got.items()}

        host = None
        for r in range(2):          # one host run at a time on the card
            if r == rank:
                host = tp_train_steps(cfg, tp_train_weights(cfg, cuda),
                                      batches, events=False, keep=keep_host)
                host["params"] = blocks(host["params"])
                free_card()
            dist.barrier()

        def keep_tp(grads, i):
            """A TP step's synced gradients against the host's: the first
            step's errors, and each step's elements whose gradient's sign
            is not the host's (0 a sign of its own)."""
            got, want = named(grads), host["grads"][i]
            if i == 0:
                return (errs(got, want), {k: sign(g) != sign(want[k][0])
                                          for k, g in got.items()})
            return None, {k: sign(g) != want[k] for k, g in got.items()}

        tp = tp_train_steps(cfg, tp_train_weights(cfg, cuda), batches,
                            mesh=mesh, events=False, keep=keep_tp)
        grad_errs = tp["grads"][0][0]
        # Adam moves an element by about lr x its gradient's sign: where
        # TP and host gradients differ in sign at a step (a rounding-level
        # gradient) their steps part by up to 2 lr; everywhere else the
        # params agree to the rule's 1e-5 of the leaf's largest entry
        flipped = {k: tp["grads"][0][1][k] | tp["grads"][1][1][k]
                   for k in grad_errs}
        got = named(tp["params"].local)
        param_errs = errs(got, host["params"],
                          {k: ~m for k, m in flipped.items()})
        flip_errs = errs(got, host["params"], flipped)
        n_flipped = {k: int(m.sum()) for k, m in flipped.items()}
        # the element of the largest error over all elements: its values
        every = errs(got, host["params"])
        leaf = max(every, key=lambda k: every[k][0])
        at = every[leaf][1]
        worst = dict(leaf=leaf, index=at, err=every[leaf][0],
                     tp=float(got[leaf].reshape(-1)[at]),
                     host=float(host["params"][leaf][0].reshape(-1)[at]),
                     flipped=bool(flipped[leaf].reshape(-1)[at]))
        want = tp_train_formula(cfg, 2, 1)
        res[arch] = dict(
            layers=layers, params={k: e for k, (e, _) in param_errs.items()},
            # absolute: against 2 x the steps' learning rates
            flip_errs={k: e * host["params"][k][1]
                       for k, (e, _) in flip_errs.items()},
            n_flipped=sum(n_flipped.values()),
            n_elements=sum(x.numel() for x in got.values()),
            most_flipped=max(n_flipped.items(), key=lambda kv: kv[1]),
            lr_sum=tp["lr_sum"],
            grads={k: e for k, (e, _) in grad_errs.items()}, worst=worst,
            counts=tp["counts"][0], want=want,
            counts_ok=all(c == want for c in tp["counts"]),
            loss=[abs(a - b) / abs(b) for a, b in zip(tp["loss"],
                                                      host["loss"])],
            grad_norm=[abs(a - b) / abs(b) for a, b in zip(
                tp["grad_norm"], host["grad_norm"])],
            ms=[host["ms"], tp["ms"]])
        del host, tp, got, flipped
        free_card()
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def start_dryrun(argv, out_dir: Path):
    """``python -m repro_torch.launch.dryrun *argv --mesh both --out
    out_dir`` started in a session of its own (its per-mesh processes
    too)."""
    import os

    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--mesh",
         "both", "--out", str(out_dir)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def dryrun_records(proc, out_dir: Path, phase: str, t0: float,
                   expect: int) -> list:
    """Waits for a :func:`start_dryrun` process (and kills its session),
    checks that it wrote ``expect`` records, prints one modeled record a
    cell and returns those that are not skipped (a shape the arch does
    not support)."""
    import os
    import shutil
    import signal

    try:
        _, err = proc.communicate(timeout=900)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    check(proc.returncode == 0, f"{phase}: dry-run failed: {err[-3000:]}")
    paths = sorted(out_dir.glob("*.json"))
    check(len(paths) == expect, f"{phase}: {len(paths)} records, not "
                                f"{expect}")
    recs = []
    for path in paths:
        rec = json.loads(path.read_text())
        key = f"{rec['arch']} x {rec['shape']} [{rec['mesh']}]"
        if rec["status"] == "skipped":
            print(f"{phase} {key}: skipped ({rec['reason']})")
            continue
        print(f"{phase} {key} (modeled, rank 0 of {rec.get('chips')}): "
              f"per chip {rec.get('flops_per_chip')} flop "
              f"({rec.get('flops_by_dtype')}), {rec.get('bytes_per_chip')} B,"
              f" peak {rec.get('peak_bytes')} B (fits_hbm "
              f"{rec.get('fits_hbm')}); collectives "
              f"{rec.get('collective_breakdown')} B in "
              f"{rec.get('collective_counts')} calls, by link "
              f"{rec.get('collective_by_link')}; compute "
              f"{rec.get('compute_s')} s (TF32 {rec.get('compute_s_tf32')}),"
              f" memory {rec.get('memory_s')} s, collective "
              f"{rec.get('collective_s')} s -> {rec.get('dominant')}")
        check(rec["status"] == "ok" and rec["flops_per_chip"] > 0,
              f"{phase}: {key} {rec.get('status')} {rec.get('error')}")
        recs.append(rec)
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"{phase} {len(recs)} cells in {time.monotonic() - t0} s")
    return recs


#: phase 12 (c)'s shapes: every one but train_4k (phase 13 (c)'s)
LM_DRYRUN_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def start_production_dryruns() -> tuple:
    """Starts phases 12 (c) and 13 (c), side by side on the host's cores
    (each mesh's count is one process; they need no card, and run beside
    the kernels' build, before any phase that is timed):
    ``python -m repro_torch.launch.dryrun --all --shape
    prefill_32k,decode_32k,long_500k --mesh both`` (every assigned LM's
    prefill, decode and long-context cells and the ParaTAA cell on pod
    (256) and multi-pod (512) at full width, rank 0's tensor-parallel
    program in fake worlds) and ``--arch dit-xl,qwen3-0.6b --shape
    train_4k --mesh both`` (rank 0's tensor-parallel train step),
    modeled.  The CPU's ``--all --mesh both`` writes the other LMs'
    train_4k records too (the same count).  Returns what
    :func:`production_dryruns` waits for."""
    lm_dir = ROOT / "build" / "chip_smoke_dryrun_lm"
    train_dir = ROOT / "build" / "chip_smoke_dryrun_train"
    return (time.monotonic(),
            (start_dryrun(["--all", "--shape", ",".join(LM_DRYRUN_SHAPES)],
                          lm_dir), lm_dir),
            (start_dryrun(["--arch", "dit-xl,qwen3-0.6b", "--shape",
                           "train_4k"], train_dir), train_dir))


def stop_dryruns(started: tuple) -> None:
    """Kills the sessions of :func:`start_production_dryruns`' processes
    (where a phase before their wait failed)."""
    import os
    import signal

    for proc, _ in started[1:]:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)


def production_dryruns(started: tuple) -> dict:
    """Waits for :func:`start_production_dryruns`' processes and prints
    and checks their records: phase 12 (c)'s, each assigned LM at each of
    LM_DRYRUN_SHAPES and the ParaTAA cell on each mesh, and 13 (c)'s four
    train cells."""
    from repro_torch.configs.registry import ASSIGNED

    t0, (lm_proc, lm_dir), (train_proc, train_dir) = started
    try:
        lm = dryrun_records(lm_proc, lm_dir, "phase 12 (c)", t0,
                            2 * (len(ASSIGNED) * len(LM_DRYRUN_SHAPES) + 1))
        train = dryrun_records(train_proc, train_dir, "phase 13 (c)", t0, 4)
    finally:
        stop_dryruns(started)
    check(len(train) == 4, f"phase 13 (c): {len(train)} records")
    return {"lm": lm, "train": train}


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
    dryruns = start_production_dryruns()
    try:
        libs = build.build_all()
    except BaseException:
        stop_dryruns(dryruns)
        raise
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
    tb = time.monotonic()
    production_dryruns(dryruns)

    t1 = time.monotonic()
    errs = check_kernels()
    times, bnd = time_kernels()
    t2 = time.monotonic()
    runs, params, cfg = main_path()
    check_main_path(runs)
    tf32 = tf32_path(params, cfg, runs)
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
    pallas = use_pallas_path(params)
    t5b = time.monotonic()

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
            use_pallas_auto_launches={
                mode: pallas[mode]["launches"][name]
                for mode in ("fused", "staged")},
            **({"stepwise_launches": serving["taa_round_launches"],
                "tf32_launches": tf32["launches"]["taa_round"]}
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
    t6 = time.monotonic()
    free_card()
    lm = backbone_path(ROOT / "build" / "chip_smoke_lm_ckpt")
    for name in ("taa_gram", "taa_apply", "taa_round"):
        run = lm["wrap"]["fused" if name == "taa_round" else "staged"]
        next(r for r in rows if r["name"] == name)["wrapper_launches"] = \
            run["launches"][name]
    t7 = time.monotonic()
    free_card()
    ssm = ssm_moe_path(ROOT / "build" / "chip_smoke_ssm_ckpt")
    for name in ("taa_gram", "taa_apply", "taa_round"):
        run = ssm["wrap"]["fused" if name == "taa_round" else "staged"]
        next(r for r in rows if r["name"] == name)[
            "ssm_wrapper_launches"] = run["launches"][name]
    t8 = time.monotonic()
    free_card()
    dryrun_against_card()
    t9 = time.monotonic()
    examples_on_card()
    t10 = time.monotonic()
    free_card()
    mesh = placement_path()
    for name in ("taa_gram", "taa_apply", "taa_round"):
        mode = "fused" if name == "taa_round" else "staged"
        next(r for r in rows if r["name"] == name)["mesh_launches"] = \
            mesh[mode]["launches"][name]
    t11 = time.monotonic()
    free_card()
    tp = tensor_parallel_path(mesh)
    for name in ("taa_gram", "taa_apply", "taa_round"):
        mode = "fused" if name == "taa_round" else "staged"
        next(r for r in rows if r["name"] == name)["tp_launches"] = \
            tp[mode]["launches"][name]
    t12 = time.monotonic()
    free_card()
    tp_lm = lm_tensor_parallel_path()
    for name in ("taa_gram", "taa_apply", "taa_round"):
        mode = "fused" if name == "taa_round" else "staged"
        next(r for r in rows if r["name"] == name)["tp_lm_launches"] = \
            tp_lm[mode]["launches"][name]
    t13 = time.monotonic()
    free_card()
    tp_train_path()
    t14 = time.monotonic()
    print(f"phase seconds: build {tb - t0}, the production dry-runs' wait "
          f"after it {t1 - tb}, taa kernels {t2 - t1}, DiT-XL "
          f"serving and TF32 {t3 - t2}, model kernels {t4 - t3}, DiT-XL "
          f"stepwise serving {t5 - t4}, --use-pallas {t5b - t5}, DiT-XL "
          f"train-checkpoint-serve {t6 - t5b}, qwen3-0.6b wrapper/LM "
          f"{t7 - t6}, mamba2/recurrentgemma/MoE {t8 - t7}, dry-run against "
          f"the card {t9 - t8}, examples {t10 - t9}, placement on a world "
          f"of one {t11 - t10}, the tensor-parallel DiT and the production "
          f"dry-run {t12 - t11}, the tensor-parallel LMs {t13 - t12}, the "
          f"tensor-parallel train step {t14 - t13}")
    # the card again, so that the end of a long log still names it
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-gloo-rank"]:
        tp_gloo_rank(int(sys.argv[2]), Path(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--tp-lm-gloo-rank"]:
        tp_lm_gloo_rank(int(sys.argv[2]), Path(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--tp-train-gloo-rank"]:
        tp_train_gloo_rank(int(sys.argv[2]), Path(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
