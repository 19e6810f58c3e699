"""The precision control of a cell's check, on the card.

    python3 bench/control.py --workload <cell> --seeds 11,12,13

For each seed it draws the cell's weights and its first requests (as many
as the check samples) as a run would, computes sequential DDIM over the
plain reference in float32 with TF32 off, then puts the reference in the
program's place in the next precision below the configuration's (float32
with TF32 matmuls: bfloat16 products) and judges that with the cell's
check.  It prints one JSON line a seed: every compared number and whether
the cell's limits fail it (they have to).  ``--precisions`` adds more
(``tf32``: the reference with TF32 products, the configuration's own
precision, for comparison).  The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.run import environment  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precisions", default="bf16")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    environment(ROOT)
    from bench.harness import check, traffic, weights
    from bench.harness.catalog import Catalog

    cat = Catalog(ROOT)
    cell = cat.cell(args.workload)
    conf, mix = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    den = cat.module("denoisers", conf["family"])
    ref = cat.module("reference", conf["family"])
    device = torch.device(args.device)
    T, spec = int(mix["T"]), cell["check"]
    n, block = int(spec["sample"]), int(spec["block"])
    dtypes = {"bf16": (torch.bfloat16, False), "tf32": (torch.float32, True)}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        params = weights.draw(den.param_defs(conf), conf["weight_seed"],
                              device, conf["weight_scales"])
        reqs = traffic.Requests(mix, seed, int(conf.get("num_classes", 0)),
                                den.sample_shape(conf))
        xi = torch.stack([reqs.noise(r) for r in range(n)]).to(device)
        labels = torch.tensor([reqs.label(r) for r in range(n)],
                              dtype=torch.long, device=device)

        def run(dtype, exact):
            return check.reference(
                lambda x, t, y: ref.eps(params, conf, x, t, y, dtype=dtype),
                xi, labels, T, block=block, exact=exact)

        want = run(torch.float32, True)
        lin = check.linear_part(xi, T)
        line = {"seed": seed}
        for name in args.precisions.split(","):
            dtype, tf32 = dtypes[name]
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            got = check.numbers(run(dtype, False), want, lin)
            failed = {k: got[k] > float(v) for k, v in spec["limits"].items()}
            line[name] = {"numbers": got, "fails_limits": any(failed.values()),
                          "failed": failed}
        line["seconds"] = time.monotonic() - t0
        print(json.dumps(line), flush=True)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
