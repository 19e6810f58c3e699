"""Triangular nonlinear system evaluation (Definition 2.1) + residuals.

`apply_F` is the banded-matrix form the solver uses; `apply_F_literal` is
a direct transcription of Definition 2.1, kept as the test oracle.  Every
tensor function takes an optional leading lane axis: the (T, T+1) system
matrices broadcast over it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coeffs import SolverCoeffs, SystemMatrices, abar_prod


def noise_term(mats: SystemMatrices, xi: torch.Tensor) -> torch.Tensor:
    """Constant part of F: ``w_xi @ xi`` -> (..., T, D) for xi (..., T+1, D)."""
    w_xi = torch.as_tensor(mats.w_xi, dtype=torch.float32, device=xi.device)
    return torch.matmul(w_xi, xi.float())


def apply_F(mats_f32, x, e, noise):
    """F^(k)(x, e): rows 0..T-1.  mats_f32 = (lift, w_eps) float32 tensors
    (T, T+1); x, e: (..., T+1, D); noise: (..., T, D)."""
    lift, w_eps = mats_f32
    return torch.matmul(lift, x) + torch.matmul(w_eps, e) + noise


def first_order_residuals(coeffs_f32, x, e, xi):
    """Paper eq. (11): r_{t-1} = ||x_{t-1} - a_t x_t - b_t e_t - c_{t-1}
    xi_{t-1}||^2 -> (..., T) with row index t-1.  coeffs_f32 = (a, b, c)
    float32 tensors (T+1,); x, e, xi: (..., T+1, D)."""
    a, b, c = coeffs_f32
    T = x.shape[-2] - 1
    pred = (a[1:, None] * x[..., 1:, :] + b[1:, None] * e[..., 1:, :]
            + c[:T, None] * xi[..., :T, :])
    diff = (x[..., :T, :] - pred).float()
    return torch.sum(diff * diff, dim=-1)


def apply_F_literal(coeffs: SolverCoeffs, order: int, x, e, xi) -> np.ndarray:
    """Direct transcription of Definition 2.1 in numpy (float64)."""
    T, a, b, c = coeffs.T, coeffs.a, coeffs.b, coeffs.c
    x = np.asarray(x, np.float64)
    e = np.asarray(e, np.float64)
    xi = np.asarray(xi, np.float64)
    out = np.zeros((T,) + x.shape[1:], np.float64)
    for t in range(1, T + 1):
        tk = min(t + order - 1, T)
        acc = abar_prod(a, t, tk) * x[tk]
        for j in range(t, tk + 1):
            acc = acc + abar_prod(a, t, j - 1) * b[j] * e[j]
            acc = acc + abar_prod(a, t, j - 1) * c[j - 1] * xi[j - 1]
        out[t - 1] = acc
    return out
