"""Model FLOPs of one DiT call on one sample: every product of the
forward, 2 m n k each, at the configuration's widths (frozen here, so a
later change to the program cannot move it)."""
from __future__ import annotations

TEMB_DIM = 256


def per_sample_call(conf: dict) -> float:
    d, heads = conf["hidden_size"], conf["num_heads"]
    ff = int(d * conf["mlp_ratio"])
    n = (conf["input_size"] // conf["patch_size"]) ** 2
    lat = conf["patch_size"] ** 2 * conf["in_channels"]
    hd = d // heads
    layer = (2 * d * 6 * d                  # adaLN modulation
             + 3 * 2 * n * d * d            # q, k, v
             + 2 * 2 * heads * n * n * hd   # scores and context
             + 2 * n * d * d                # output projection
             + 3 * 2 * n * d * ff)          # gated MLP
    top = (2 * n * lat * d + 2 * TEMB_DIM * d + 2 * d * d
           + 2 * d * 2 * d + 2 * n * d * lat)
    return float(conf["depth"] * layer + top)
