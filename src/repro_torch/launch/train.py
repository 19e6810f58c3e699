"""Training driver (the DiT denoiser and the LM backbones): config ->
model -> data pipeline -> AdamW -> async checkpoints -> fault-tolerance
supervision.  Runs on CUDA unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch dit-xl --smoke \\
        --steps 30 --batch 16 --ckpt-dir /path/to/ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 10 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-2b --smoke --device cpu

A rerun with the same ``--ckpt-dir`` and more ``--steps`` resumes from the
latest checkpoint; ``python -m repro_torch.launch.serve --ckpt DIR`` serves
a DiT's.  An LM trains on the synthetic token stream (``TokenPipeline``;
random frame embeddings for ``frontend="embed"`` archs).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataConfig, LatentPipeline, \
    TokenPipeline
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.diffusion.convert import dit_init
from repro_torch.launch import steps as S
from repro_torch.models.convert import backbone_init
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import (RestartPolicy, StragglerMitigator,
                                 run_supervised)


def build_state(cfg, seed: int, device: DeviceLike = None,
                dtype=torch.float32):
    """Random DiT or backbone params (the port's numpy initializers) and
    their AdamW state on ``device``."""
    init = dit_init if cfg.is_diffusion else backbone_init
    params = init(cfg, seed, device, dtype=dtype)
    return params, adamw_init(params)


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    state: Dict                 # {"params", "opt"} after the last step
    start_step: int             # the step the run resumed from
    #: per executed step: host wall ms (batch + step + the loss read), and
    #: on CUDA the device ms of forward+backward (from the step's first
    #: launch, the batch queued) and of the update
    step_ms: List[Dict] = dataclasses.field(default_factory=list)


class _StepTimer:
    """CUDA events at a step's start, between its backward pass and its
    update, and at its end (nothing on the CPU)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events: List = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

    def split_ms(self) -> Dict:
        if not self.cuda:
            return {}
        start, mid, end = self.events[-3:]
        end.synchronize()
        return {"fwd_bwd_ms": start.elapsed_time(mid),
                "update_ms": mid.elapsed_time(end)}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128,
                   help="LM sequence length (unused by the DiT)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cpu for a host run)")
    return p.parse_args(argv)


def resolve_arch(args):
    """The --arch config (reduced with --smoke); exits for an unknown
    arch."""
    try:
        cfg = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(e.args[0]) from e
    return cfg.reduced() if args.smoke else cfg


def batch_fn(args, cfg, device):
    """step -> the step's batch on ``device``: the DiT's latent batches
    (16 tokens, as the reference trains), or an LM's token batches
    (``--seq`` tokens; random frame embeddings as inputs for
    ``frontend="embed"`` archs, as the reference makes them)."""
    if cfg.is_diffusion:
        pipe = LatentPipeline(num_tokens=16, latent_dim=cfg.latent_dim,
                              num_classes=cfg.num_classes, seed=args.seed)
        dtypes = {"latents": torch.float32, "noise": torch.float32,
                  "labels": torch.int32, "t": torch.int32}
        return lambda step: {k: to_device(v, dtypes[k], device)
                             for k, v in pipe.batch(step, args.batch).items()}
    tokens = TokenPipeline(DataConfig(seq_len=args.seq,
                                      global_batch=args.batch,
                                      vocab_size=cfg.vocab_size,
                                      seed=args.seed))

    def get_batch(step):
        b = tokens.batch(step)
        labels = to_device(b["labels"], torch.int32, device)
        if cfg.frontend == "embed":
            rng = np.random.default_rng(step)
            emb = rng.normal(size=(args.batch, args.seq, cfg.d_model)) * 0.05
            return {"inputs": to_device(emb, torch.float32, device),
                    "labels": labels}
        return {"inputs": to_device(b["inputs"], torch.int32, device),
                "labels": labels}
    return get_batch


def train(args, cfg, params, opt_state) -> TrainResult:
    """Train from ``params``/``opt_state`` (or from the latest checkpoint in
    ``--ckpt-dir``) up to ``--steps``, under :func:`run_supervised`."""
    device = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=args.lr, weight_decay=0.01)
    train_step = S.make_train_step(cfg, opt_cfg, total_steps=args.steps)
    get_batch = batch_fn(args, cfg, device)

    ckpt = CheckpointManager(Path(args.ckpt_dir), keep=3) \
        if args.ckpt_dir else None
    straggler = StragglerMitigator()
    state = {"params": params, "opt": opt_state}
    result = TrainResult(losses=[], state=state, start_step=0)

    def do_step(step):
        t0 = time.monotonic()
        batch = get_batch(step)
        timer = _StepTimer(device)
        timer.mark()
        state["params"], state["opt"], metrics = train_step(
            state["params"], state["opt"], batch,
            to_device(step, torch.int32, device), mark=timer.mark)
        timer.mark()
        loss = float(metrics["loss"])
        wall = time.monotonic() - t0
        result.losses.append(loss)
        result.step_ms.append({"step": step, "wall_ms": wall * 1e3,
                               **timer.split_ms()})
        straggler.record(wall)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({wall:.2f}s)", flush=True)

    def save(step):
        if ckpt:
            ckpt.save(step, {"step": step, **state})

    def restore():
        if not ckpt:
            return 0
        step, tree = ckpt.restore({"step": 0, **state})
        if tree is None:
            return 0
        state["params"], state["opt"] = tree["params"], tree["opt"]
        return int(tree["step"])

    start = result.start_step = restore()
    if start:
        print(f"restored checkpoint step {start}")
    run_supervised(do_step, start_step=start, num_steps=args.steps,
                   save_fn=save, restore_fn=restore,
                   policy=RestartPolicy(), ckpt_every=args.ckpt_every)
    if ckpt:
        ckpt.save(args.steps, {"step": args.steps, **state}, blocking=True)
    if result.losses:
        print(f"final loss {result.losses[-1]:.4f} "
              f"(first {result.losses[0]:.4f})")
    return result


def run(argv=None) -> TrainResult:
    """``main`` with its whole result (state, step times) returned."""
    args = parse_args(argv)
    cfg = resolve_arch(args)
    params, opt_state = build_state(cfg, args.seed, resolve_device(args.device))
    return train(args, cfg, params, opt_state)


def main(argv=None) -> List[float]:
    """Returns the losses of the steps this run executed."""
    return run(argv).losses


if __name__ == "__main__":
    main()
