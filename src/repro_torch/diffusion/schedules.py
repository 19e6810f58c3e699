"""Noise schedules for VP diffusion (DDPM-style alpha-bar grids)."""
from __future__ import annotations

import numpy as np


def linear_beta_schedule(n: int = 1000, beta_min: float = 1e-4, beta_max: float = 0.02):
    return np.linspace(beta_min, beta_max, n, dtype=np.float64)


def cosine_alpha_bar(n: int = 1000, s: float = 0.008):
    t = np.arange(n + 1, dtype=np.float64) / n
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    return np.clip(f / f[0], 1e-8, 1.0)[1:]


def alpha_bar_from_betas(betas: np.ndarray) -> np.ndarray:
    return np.cumprod(1.0 - betas)


def make_schedule(kind: str = "linear", n_train: int = 1000):
    """Returns (alpha_bar (n_train,), betas (n_train,)) in float64."""
    if kind == "linear":
        betas = linear_beta_schedule(n_train)
        return alpha_bar_from_betas(betas), betas
    if kind == "cosine":
        abar = cosine_alpha_bar(n_train)
        prev = np.concatenate([[1.0], abar[:-1]])
        betas = np.clip(1.0 - abar / prev, 1e-8, 0.999)
        return abar, betas
    raise ValueError(kind)


def sampling_grid(n_train: int, num_steps: int) -> np.ndarray:
    """Evenly spaced training-schedule timesteps tau_1 < ... < tau_T
    (int indices into the training schedule), DDIM-style."""
    step = n_train // num_steps
    taus = np.arange(1, num_steps + 1) * step - 1  # last = n_train-1
    return taus.astype(np.int64)
