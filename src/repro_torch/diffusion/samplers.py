"""Sequential reference sampler — the autoregressive procedure (paper eq. 6)
— and the noise convention.

These are the ground truth that parallel sampling must reproduce (Thm 2.2:
the triangular system's unique solution IS this trajectory).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.coeffs import SolverCoeffs


def draw_noises(seed: int, coeffs: SolverCoeffs, shape: Sequence[int], *,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """xi: (T+1, *shape) float32; xi[T] is the initial noise x_T, xi[0..T-1]
    the per-step noises (scaled by c_t; zero-weight for ODE samplers).

    Drawn from a ``torch.Generator`` seeded with ``seed`` on the CPU and
    moved to ``device``, so a seed gives the same noise on every device.
    (The JAX package draws from ``jax.random``; the two do not agree bit
    for bit, so parity tests inject the reference's noise instead.)"""
    gen = torch.Generator().manual_seed(int(seed))
    xi = torch.randn((coeffs.T + 1,) + tuple(shape), generator=gen,
                     dtype=torch.float32)
    return xi if device is None else xi.to(device)


def _sequential_sample(eps_fn, coeffs: SolverCoeffs, xi: torch.Tensor, *,
                       return_traj: bool = False) -> torch.Tensor:
    """Runs eq. (6) exactly: T sequential eps evaluations, every lane at once.

    eps_fn: (x (B, *shape), taus (B,)) -> (B, *shape)
    xi:     (B, T+1, *shape) noises (xi[:, T] = x_T)
    Returns x_0 (B, *shape), or the full trajectory (B, T+1, *shape).
    """
    T = coeffs.T
    dev = xi.device

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    a, b, c, taus = col(coeffs.a), col(coeffs.b), col(coeffs.c), \
        col(coeffs.taus)
    B = xi.shape[0]
    x_t = xi[:, T]
    rows = [None] * T + [x_t]
    for t in range(T, 0, -1):
        e = eps_fn(x_t, taus[t].expand(B))
        x_t = a[t] * x_t + b[t] * e + c[t - 1] * xi[:, t - 1]
        rows[t - 1] = x_t
    if not return_traj:
        return x_t
    return torch.stack(rows, dim=1)
