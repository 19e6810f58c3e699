"""Anderson Acceleration variants for the triangular system.

Modes:
  fp   — plain fixed-point iteration (eq. 10); also what m=1 reduces to.
  aa   — standard Anderson Acceleration (eq. 12-13), dense inverse-Jacobian.
  aa+  — heuristic block-upper-triangular extraction of the standard AA
         matrix (Appendix B / Fig. 6c).
  taa  — Triangular Anderson Acceleration (Theorem 3.2), the paper's method.

Theorem 3.2's per-row-block closed form needs the suffix Grams
F_{t:t2}^T F_{t:t2} (m x m) and F_{t:t2}^T R_{t:t2} (m): suffix sums of
per-row blocks, so one reverse cumulative sum gives every row block.  The
memory-bound passes go through :mod:`repro_torch.kernels.ops` — the
hand-written kernels for a CUDA tensor, the plain versions for a CPU one.
Grams and solves run in float32 even for bf16 trajectories.

Every tensor carries a leading lane axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as _ops


def anderson_update(x_rows, R, dX, dF, window_mask, *, mode: str,
                    lam: float, safeguard_mask=None,
                    fuse_round: bool = False):
    """One accelerated update over the active window.

    x_rows: (B, T, D) current iterate rows 0..T-1
    R:      (B, T, D) update residuals F^(k)(x) - x
    dX, dF: (B, m, T, D) history ring buffers (zero-filled when empty)
    window_mask: (B, T) bool — active rows [t1, t2]
    safeguard_mask: (B, T) bool — rows whose *suffix* residuals have all
        converged; Theorem 3.6 forces those rows to the plain FP update.
    fuse_round: the whole round as one ``ops.taa_round`` dispatch (one
        kernel launch on the card) instead of the staged Gram -> solve ->
        apply; on the CPU both are the same staged composition.
    Returns x_new rows (B, T, D) (only window rows are meaningful).
    """
    if mode == "fp":
        return torch.where(window_mask[..., None], x_rows + R, x_rows)
    wmask = window_mask.to(torch.float32)
    round_fn = _ops.taa_round if fuse_round else _ops.taa_round_staged
    return round_fn(x_rows, R, dX, dF, wmask, mode=mode, lam=lam,
                    safeguard_mask=safeguard_mask)


# ---------------------------------------------------------------------------
# Literal oracle for Theorem 3.2 (tests only)
# ---------------------------------------------------------------------------


def taa_update_literal(x_rows, R, dX, dF, t1: int, t2: int, lam: float):
    """Per-row-block transcription of Theorem 3.2 in numpy float32, one
    lane (x_rows (T, D), dX/dF (m, T, D)).  O(T^2 d m) — validates the
    suffix-cumsum restructuring."""
    x_rows = np.asarray(x_rows, np.float32)
    R = np.asarray(R, np.float32)
    dX = np.asarray(dX, np.float32)
    dF = np.asarray(dF, np.float32)
    m = dX.shape[0]
    out = x_rows.copy()
    for t in range(t1, t2 + 1):
        Fsuf = dF[:, t : t2 + 1].reshape(m, -1).T      # ((t2-t+1)*D, m)
        Rsuf = R[t : t2 + 1].reshape(-1)               # ((t2-t+1)*D,)
        M = Fsuf.T @ Fsuf + lam * np.eye(m, dtype=np.float32)
        gamma = np.linalg.solve(M, Fsuf.T @ Rsuf)      # (m,)
        corr = ((dX[:, t] + dF[:, t]).T @ gamma)       # (D,)
        out[t] = x_rows[t] + R[t] - corr
    return out
