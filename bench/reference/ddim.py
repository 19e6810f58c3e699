"""Plain DDIM: the schedule's coefficients and the sequential sampler.

The recursion every first-order sampler follows (DDIM, Song et al. 2020,
eq. 12; ParaTAA, Tang et al. 2024, eq. 6):

    x_{t-1} = a_t x_t + b_t eps(x_t, tau_t) + c_{t-1} xi_{t-1},  t = T..1

with x_T = xi_T, on the linear beta schedule (1e-4 to 0.02 over 1000
training steps, Ho et al. 2020) at the evenly spaced timesteps tau_t =
t * (1000 // T) - 1.  Worked out here in float64 from those definitions
alone; nothing is read from the program under test.
"""
from __future__ import annotations

import math

import torch


def coefficients(T: int, eta: float = 0.0, n_train: int = 1000,
                 beta_min: float = 1e-4, beta_max: float = 0.02):
    """(a, b, c, taus) as float64 lists of length T + 1: a[t], b[t] for t
    = 1..T, c[t] for t = 0..T-1, taus[t] the training timestep of row t."""
    betas = [beta_min + (beta_max - beta_min) * i / (n_train - 1)
             for i in range(n_train)]
    abar_full, prod = [], 1.0
    for beta in betas:
        prod *= 1.0 - beta
        abar_full.append(prod)
    step = n_train // T
    taus = [0.0] + [float(t * step - 1) for t in range(1, T + 1)]
    abar = [1.0] + [abar_full[int(taus[t])] for t in range(1, T + 1)]
    a, b, c = [0.0] * (T + 1), [0.0] * (T + 1), [0.0] * (T + 1)
    for t in range(1, T + 1):
        ab_t, ab_p = abar[t], abar[t - 1]
        sigma = eta * math.sqrt((1 - ab_p) / (1 - ab_t)) \
            * math.sqrt(1 - ab_t / ab_p)
        a[t] = math.sqrt(ab_p / ab_t)
        b[t] = math.sqrt(max(1 - ab_p - sigma ** 2, 0.0)) \
            - math.sqrt(ab_p * (1 - ab_t) / ab_t)
        c[t - 1] = sigma
    return a, b, c, taus


def sample(eps_fn, xi: torch.Tensor, T: int, eta: float = 0.0):
    """Sequential DDIM over a batch.  xi: (B, T+1, *shape) float32 noises
    (xi[:, T] = x_T); eps_fn(x (B, *shape), t (B,) float) -> eps.
    Returns the trajectory (B, T+1, *shape) in float32, row t = x_t."""
    a, b, c, taus = coefficients(T, eta)
    B = xi.shape[0]
    rows = [None] * (T + 1)
    x = xi[:, T].float()
    rows[T] = x
    for t in range(T, 0, -1):
        tt = torch.full((B,), taus[t], dtype=torch.float32, device=x.device)
        e = eps_fn(x, tt).float()
        x = a[t] * x + b[t] * e + c[t - 1] * xi[:, t - 1].float()
        rows[t - 1] = x
    return torch.stack(rows, dim=1)
