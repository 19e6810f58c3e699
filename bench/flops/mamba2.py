"""Model FLOPs of one Mamba2-trunk denoiser call on one sample: every
product of the forward, 2 m n k each, the SSD in its chunked form at the
configuration's chunk size (frozen here, so a later change to the
program cannot move it)."""
from __future__ import annotations

import math

TEMB_DIM = 256


def per_sample_call(conf: dict) -> float:
    d, n = conf["d_model"], conf["tokens"]
    din = conf["expand"] * d
    p, state, g = conf["headdim"], conf["d_state"], conf["ngroups"]
    h = din // p
    q = min(conf["chunk_size"], n)
    nc = math.ceil(n / q)
    proj = 2 * n * d * (2 * din + 2 * g * state + h) + 2 * n * din * d
    ssd = (2 * nc * g * q * q * state      # C . B within a chunk
           + 2 * nc * h * q * q * p        # intra-chunk outputs
           + 2 * nc * h * p * state * q    # chunk states
           + 2 * nc * q * h * p * state)   # inter-chunk outputs
    if nc > 1:                             # states across chunks
        ssd += 2 * h * nc * nc * p * state
    lat = conf["latent_dim"]
    top = 2 * n * lat * d + 2 * TEMB_DIM * d + 2 * d * d + 2 * n * d * lat
    return float(conf["n_layer"] * (proj + ssd) + top)
