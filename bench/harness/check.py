"""Whether what the timed path produced is right: the served requests'
trajectories against plain sequential DDIM over the plain reference, from
the same noise, labels and weights.

The reference (``bench/reference/<family>.py``) runs in float32 with TF32
off, in blocks of requests, after the window has closed and the program's
state is freed.  The compared number, ``x0_err``, is the worst over the
sampled requests of |x0 - x0_ref| / |x0_ref - x0_lin|, where x0_lin is
the trajectory's end with eps = 0 (the schedule's linear part): the error
against the part of x0 that the denoiser shapes.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import numpy as np
import torch

from bench.reference import ddim
from bench.reference.shared import exact_float32


def sample_requests(records: List, seed: int, size: int) -> List:
    """Up to ``size`` of the window's finished requests, drawn from the
    seed, the one that took the most iterations always among them."""
    if not records:
        return []
    rng = np.random.default_rng([int(seed) % 2 ** 63, 17])
    order = sorted(records, key=lambda r: r.rid)
    hardest = max(order, key=lambda r: (r.result.iters, -r.rid))
    rest = [r for r in order if r is not hardest]
    picks = rng.permutation(len(rest))[:max(size - 1, 0)]
    return [hardest] + [rest[i] for i in sorted(picks)]


def linear_part(xi: torch.Tensor, T: int) -> torch.Tensor:
    """The trajectory with eps = 0: (B, T+1, ...) float32."""
    return ddim.sample(lambda x, t: torch.zeros_like(x), xi, T)


def reference(eps: Callable, xi: torch.Tensor, labels: torch.Tensor, T: int,
              *, block: int, exact: bool = True) -> torch.Tensor:
    """Sequential DDIM over ``eps(x, t, y)``, ``block`` requests at a time;
    ``exact`` runs it in float32 with TF32 off.  (B, T+1, ...) float32 on
    xi's device."""
    out = []
    for lo in range(0, xi.shape[0], block):
        y = labels[lo:lo + block]
        with torch.inference_mode(), (exact_float32() if exact
                                      else contextlib.nullcontext()):
            out.append(ddim.sample(lambda x, t, y=y: eps(x, t, y),
                                   xi[lo:lo + block], T))
    return torch.cat(out)


def numbers(traj: torch.Tensor, ref: torch.Tensor,
            lin: torch.Tensor) -> Dict[str, float]:
    """The compared numbers (module docstring), worst over the batch.
    ``traj``/``ref``/``lin``: (B, T+1, ...) float32, row 0 = x0."""
    err = (traj[:, 0] - ref[:, 0]).flatten(1).double().norm(dim=-1)
    shaped = (ref[:, 0] - lin[:, 0]).flatten(1).double().norm(dim=-1)
    return {"x0_err": float((err / shaped).max())}
