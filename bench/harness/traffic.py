"""The one traffic generator: every mix is a file of parameters it reads.

A mix (``bench/traffic/<name>.json``) states the arrival process, the
number of clients, the sampler and its step count T, the engine's slots
and iterations a round, how labels are drawn, and ``lead_in_s`` (0 when
the mix leaves it out): the seconds the traffic runs before the measured
window opens, so that the window sees the system full.  ``arrival`` names
``bench/arrivals/<arrival>.py``, which says when each request is sent.
Request ``rid`` (numbered in the order they are sent) draws its label and
its noise from (seed, rid) alone, so a seed always gives the same requests
whatever their timing.
"""
from __future__ import annotations

import numpy as np
import torch

#: every seed is taken modulo this, so any whole number is a seed
SEED_SPACE = 2 ** 63


def check(mix: dict) -> dict:
    if mix["labels"] != "uniform":
        raise ValueError(f"labels {mix['labels']!r}: only 'uniform'")
    if mix["schedule"] != "ddim":
        raise ValueError(f"schedule {mix['schedule']!r}: only 'ddim'")
    for key in ("clients", "slots", "chunk_iters", "T"):
        if int(mix[key]) < 1:
            raise ValueError(f"{key} must be >= 1")
    if float(mix.get("lead_in_s", 0.0)) < 0:
        raise ValueError("lead_in_s must be >= 0")
    return mix


class Requests:
    """Request ``rid``'s label and noise under ``seed`` for one mix."""

    def __init__(self, mix: dict, seed: int, num_classes: int,
                 sample_shape):
        self.mix = check(mix)
        self.seed = int(seed) % SEED_SPACE
        self.num_classes = num_classes
        self.shape = (int(mix["T"]) + 1,) + tuple(sample_shape)

    def label(self, rid: int) -> int:
        """Uniform over the classes (0 for a model that takes none)."""
        if not self.num_classes:
            return 0
        rng = np.random.default_rng([self.seed, int(rid) % SEED_SPACE])
        return int(rng.integers(self.num_classes))

    def noise(self, rid: int) -> torch.Tensor:
        """(T+1, *sample_shape) float32 on the host: xi[T] is x_T."""
        gen = torch.Generator().manual_seed(
            (self.seed * 1_000_003 + int(rid)) % SEED_SPACE)
        return torch.randn(self.shape, generator=gen, dtype=torch.float32)
