"""End to end in the PyTorch port: train a reduced DiT for a few hundred
steps with checkpoints and fault-tolerant supervision, then serve batched
sampling requests with ParaTAA from the checkpoint, and sequential DDIM as
the reference (the port's counterpart of examples/train_and_serve.py).
ParaTAA's x0 must match sequential's within 2e-2 relative.

    PYTHONPATH=src python examples/torch_train_and_serve.py --steps 200 \\
        --device cpu

Runs on CUDA unless ``--device cpu``.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=4,
                   help="requests per SamplingEngine dispatch")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu for a host run)")
    args = p.parse_args(argv)
    dev = ["--device", args.device]

    with tempfile.TemporaryDirectory() as ckdir:
        print("=== training (checkpointed, supervised) ===")
        train_main(["--arch", "dit-xl", "--smoke", "--steps", str(args.steps),
                    "--batch", "16", "--ckpt-dir", ckdir, "--ckpt-every", "50",
                    "--log-every", "25"] + dev)
        print("\n=== serving with ParaTAA (restored from checkpoint) ===")
        taa, stats = serve_main(
            ["--smoke", "--requests", str(args.requests), "--batch-size",
             str(args.batch_size), "--steps-T", "50", "--solver", "taa",
             "--ckpt", ckdir] + dev)
        print("\n=== reference: sequential sampling ===")
        seq, _ = serve_main(["--smoke", "--requests", "1", "--steps-T", "50",
                             "--solver", "seq", "--ckpt", ckdir] + dev)
    # the first request of both runs is the same (label, seed)
    err = float(np.linalg.norm(taa[0] - seq[0]) / np.linalg.norm(seq[0]))
    print(f"\nParaTAA x0 against sequential: rel err {err:.2e} in "
          f"{stats[0]['iters']} parallel steps (sequential: 50)")
    assert err < 2e-2, err
    return err


if __name__ == "__main__":
    main()
