"""Solver coefficients: every first-order sampler (DDIM eta in [0,1], DDPM)
is the autoregressive recurrence (paper eq. 6)

    x_{t-1} = a_t x_t + b_t eps(x_t, tau_t) + c_{t-1} xi_{t-1},  t = T..1

with x_T = xi_T.  This module derives (a, b, c) from a diffusion schedule —
the "adjust the coefficients" hook that lets ParaTAA wrap any sequential
sampler — plus the k-th order banded weight matrices of Definition 2.1.

Index conventions (arrays sized T+1, float64 -> float32):
  a[t], b[t]  : valid for t = 1..T        (a[0] = b[0] = 0, unused)
  c[t]        : multiplies xi_t, valid t = 0..T-1 (c[T] = 0; xi_T is x_T)
  taus[t]     : training-schedule timestep fed to eps_theta, t = 1..T
  abar[t]     : cumulative alpha-bar at grid point t (abar[0] = 1: clean data)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.diffusion.schedules import make_schedule, sampling_grid


@dataclasses.dataclass(frozen=True)
class SolverCoeffs:
    a: np.ndarray        # (T+1,)
    b: np.ndarray        # (T+1,)
    c: np.ndarray        # (T+1,)
    taus: np.ndarray     # (T+1,) float timesteps for eps_theta (taus[0]=0)
    g2: np.ndarray       # (T+1,) g^2(t) proxy for the stopping criterion
    eta: float
    T: int

    @property
    def is_ode(self) -> bool:
        return float(np.max(np.abs(self.c))) == 0.0

    def cache_key(self) -> tuple:
        """A hashable key of these values (the arrays are not hashable), for
        the device constants built from them."""
        return (self.T, self.eta) + tuple(
            np.asarray(v, np.float64).tobytes()
            for v in (self.a, self.b, self.c, self.taus, self.g2))


def ddim_coeffs(num_steps: int, eta: float = 0.0, schedule: str = "linear",
                n_train: int = 1000) -> SolverCoeffs:
    """eta = 0 -> DDIM (ODE); eta = 1 -> DDPM (SDE), per Song et al. 2020a."""
    abar_full, betas_full = make_schedule(schedule, n_train)
    grid = sampling_grid(n_train, num_steps)  # (T,) indices, t=1..T
    T = num_steps
    abar = np.ones(T + 1, np.float64)
    abar[1:] = abar_full[grid]

    a = np.zeros(T + 1, np.float64)
    b = np.zeros(T + 1, np.float64)
    c = np.zeros(T + 1, np.float64)
    for t in range(1, T + 1):
        ab_t, ab_p = abar[t], abar[t - 1]
        sigma = eta * np.sqrt((1 - ab_p) / (1 - ab_t)) * np.sqrt(1 - ab_t / ab_p)
        a[t] = np.sqrt(ab_p / ab_t)
        b[t] = np.sqrt(max(1 - ab_p - sigma**2, 0.0)) - np.sqrt(ab_p * (1 - ab_t) / ab_t)
        c[t - 1] = sigma

    taus = np.zeros(T + 1, np.float64)
    taus[1:] = grid.astype(np.float64)
    # stopping threshold scale: continuous-time VP-SDE diffusion coefficient
    # g^2(t) = beta(t) ~ n_train * beta_discrete at the grid point, following
    # Shih et al. 2023 / paper Sec 2.1
    g2 = np.zeros(T + 1, np.float64)
    g2[1:] = betas_full[grid] * n_train
    g2[0] = g2[1]
    return SolverCoeffs(a=a, b=b, c=c, taus=taus, g2=g2, eta=eta, T=T)


def ddpm_coeffs(num_steps: int, schedule: str = "linear", n_train: int = 1000):
    """Following the paper (and Song et al. 2020a): DDIM with eta=1 is the
    DDPM sampler."""
    return ddim_coeffs(num_steps, eta=1.0, schedule=schedule, n_train=n_train)


# ---------------------------------------------------------------------------
# k-th order banded weight matrices (Definition 2.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SystemMatrices:
    """F^(k)(x, e) = lift @ x + w_eps @ e + (w_xi @ xi).

    Rows index equations t-1 = 0..T-1 (unknown x_{t-1}); columns index the
    trajectory 0..T.  All built in float64, consumed as float32.
    """
    lift: np.ndarray   # (T, T+1) picks abar_{t,t_k} * x_{t_k}
    w_eps: np.ndarray  # (T, T+1) banded eps weights
    w_xi: np.ndarray   # (T, T+1) banded noise weights
    order: int

    def as_f32(self):
        return (self.lift.astype(np.float32), self.w_eps.astype(np.float32),
                self.w_xi.astype(np.float32))


def abar_prod(a: np.ndarray, i: int, s: int) -> float:
    """abar_{i,s} = prod_{j=i}^{s} a_j (1.0 when s < i)."""
    if s < i:
        return 1.0
    return float(np.prod(a[i : s + 1]))


def system_matrices(coeffs: SolverCoeffs, order: int) -> SystemMatrices:
    """Definition 2.1: the k-th order triangular nonlinear system."""
    T, a, b, c = coeffs.T, coeffs.a, coeffs.b, coeffs.c
    k = order
    assert 1 <= k <= T, (k, T)
    lift = np.zeros((T, T + 1), np.float64)
    w_eps = np.zeros((T, T + 1), np.float64)
    w_xi = np.zeros((T, T + 1), np.float64)
    for t in range(1, T + 1):  # equation t produces row t-1
        tk = min(t + k - 1, T)
        lift[t - 1, tk] = abar_prod(a, t, tk)
        for j in range(t, tk + 1):
            ab = abar_prod(a, t, j - 1)
            w_eps[t - 1, j] = ab * b[j]
            w_xi[t - 1, j - 1] = ab * c[j - 1]
    return SystemMatrices(lift=lift, w_eps=w_eps, w_xi=w_xi, order=k)
