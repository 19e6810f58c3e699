"""Render the dry-run's JSON records of one mesh as a roofline table (the
JAX package's ``repro.roofline.report``): ``one-card`` (one H100, the
default), or the production meshes ``single`` (pod, 256 ranks) and
``multi`` (multi-pod, 512), whose numbers are rank 0's.

    PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun
    PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun --mesh single

Every number in the table is modeled from H100 constants
(``roofline.analysis``) and counted ops (``roofline.counter``): none is
measured on the card.  Bytes are the eager program's, op by op, not a
compiler's after fusion; collective bytes are priced by the link each
group crosses (NVLink inside a node of 8 ranks, the network between).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ARCH_ORDER = ["recurrentgemma-2b", "musicgen-medium", "qwen3-0.6b",
              "granite-8b", "qwen2-72b", "h2o-danube-3-4b", "mamba2-1.3b",
              "moonshot-v1-16b-a3b", "qwen2-moe-a2.7b", "qwen2-vl-2b",
              "dit-xl"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "parataa_serve"]


#: the table's heading of each mesh label
HEADINGS = {"one-card": "one H100",
            "single": "pod mesh, 16 x 16 = 256 H100s, rank 0",
            "multi": "multi-pod mesh, 2 x 16 x 16 = 512 H100s, rank 0"}


def load(results_dir: Path, mesh: str = "one-card"):
    recs = {}
    for p in results_dir.glob(f"*__{mesh}.json"):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"])] = r
    return recs


def fmt_ms(x):
    return f"{x * 1e3:.2f}" if x is not None else "-"


def render(results_dir: str, mesh: str = "one-card") -> str:
    recs = load(Path(results_dir), mesh)
    lines = [
        f"### Roofline table — {HEADINGS[mesh]} (modeled, not measured: "
        f"H100 SXM constants; eager op-by-op bytes"
        + ("" if mesh == "one-card" else
           "; collectives at 450 GB/s NVLink inside 8-rank nodes, 50 GB/s "
           "across") + ")",
        "",
        "| arch | shape | compute (ms) | compute TF32 (ms) | memory (ms) | "
        "collective (ms) | dominant | fits HBM | peak GB | MODEL/counted "
        "flops | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                             f"- | - | SKIP: {r['reason'][:70]} |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                             f"- | - | ERROR: {str(r.get('error'))[:60]} |")
                continue
            mf = r.get("model_flops_ratio")
            lines.append(
                f"| {arch} | {shape} | {fmt_ms(r['compute_s'])} | "
                f"{fmt_ms(r.get('compute_s_tf32'))} | "
                f"{fmt_ms(r['memory_s'])} | {fmt_ms(r['collective_s'])} | "
                f"**{r['dominant']}** | {'Y' if r['fits_hbm'] else 'N'} | "
                f"{r['peak_bytes'] / 1e9:.1f} | "
                f"{mf and f'{mf:.3f}' or '-'} | {r.get('note', '')} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("results_dir")
    p.add_argument("--mesh", default="one-card", choices=sorted(HEADINGS))
    args = p.parse_args(argv)
    print(render(args.results_dir, args.mesh))


if __name__ == "__main__":
    main()
