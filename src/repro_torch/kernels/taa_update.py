"""The three Anderson/TAA update kernels, hand-written in CUDA C++ for
Hopper (``csrc/taa_update.cu``), built with ``nvcc`` at first use and
loaded with ``ctypes``.

They replace the Pallas TPU kernels of ``repro/kernels/taa_update.py``:

  taa_gram   per-row masked Gram blocks G_t = (w dF_t)(w dF_t)^T, u_t =
             (w dF_t)(w R_t)                      [replaces taa_gram]
  taa_apply  x_t + R_t - (dX_t + dF_t)^T gamma_t on rows with mask > 0
                                                   [replaces taa_apply]
  taa_round  the whole round in one launch: Gram sweep, suffix (taa) /
             global (aa; aa+ Gram only) sums + ridge, pivot-free
             Gauss-Jordan solves, guard rows gamma = 0, apply
                                                   [replaces taa_round]

Every kernel takes the lane axis natively: dF (B, m, T, D), R (B, T, D),
mask (B, T), gamma (B, T, m); one launch serves every lane of an engine
dispatch.  The wrappers also take the unbatched shapes of the JAX package
(no lane axis) and add one.  The plain PyTorch versions live in
:mod:`repro_torch.kernels.ref`; these wrappers never call them.  Each
wrapper counts its launches in :data:`launches`.

Nothing here imports or builds anything at import time: the library is
compiled on the first launch (:mod:`repro_torch.kernels.build`), into
``build/kernels/`` at the repository root, named by a hash of the source so
an edit rebuilds.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS  # noqa: F401

SOURCE = _build.CSRC / "taa_update.cu"
MAX_M = 8
MODES = {"taa": 0, "aa": 1, "aa+": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches per kernel since the last :func:`reset_launches` — one is added
#: where a wrapper launches its kernel, and nowhere else
launches: Dict[str, int] = {"taa_gram": 0, "taa_apply": 0, "taa_round": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def library_path() -> Path:
    return _build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.taa_gram_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.taa_apply_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.taa_round_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, F,
                                     I, P]
    for fn in (lib.taa_gram_launch, lib.taa_apply_launch,
               lib.taa_round_launch):
        fn.restype = I
    return lib


def _lanes(hist: torch.Tensor, *rest: torch.Tensor):
    """Add the lane axis to unbatched JAX-shaped inputs (hist (m, T, D))."""
    if hist.dim() == 3:
        return True, (hist[None],) + tuple(r[None] for r in rest)
    return False, (hist,) + rest


def _check(name: str, hists: Tuple[torch.Tensor, ...],
           rows: Tuple[torch.Tensor, ...], per_row: Tuple[torch.Tensor, ...]):
    """Validate (B, m, T, D) histories, (B, T, D) rows of the same type and
    float32 per-row tensors ((B, T) masks, (B, T, m) gamma), all
    contiguous; then that they lie on one CUDA device.  Returns (B, m, T,
    D)."""
    hist = hists[0]
    if hist.dim() != 4:
        raise ValueError(f"{name}: histories must be (B, m, T, D), got "
                         f"{tuple(hist.shape)}")
    B, m, T, D = hist.shape
    if not 1 <= m <= MAX_M:
        raise ValueError(f"{name}: history size m={m} outside [1, {MAX_M}]")
    if hist.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {hist.dtype} not float32/bfloat16")
    for group, want, dtype in ((hists, (B, m, T, D), hist.dtype),
                               (rows, (B, T, D), hist.dtype)):
        for t in group:
            if tuple(t.shape) != want or t.dtype != dtype:
                raise ValueError(f"{name}: expected {want} {dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
    for t in per_row:
        want = (B, T, m) if t.dim() == 3 else (B, T)   # gamma / mask, guard
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {want}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _build.check_on_one_card(name, *hists, *rows, *per_row)
    return B, m, T, D


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def taa_gram(dF: torch.Tensor, R: torch.Tensor, mask: torch.Tensor):
    """dF (B, m, T, D), R (B, T, D), mask (B, T) -> (G (B, T, m, m),
    u (B, T, m)) float32.  Unbatched (m, T, D)/(T, D)/(T,) also taken."""
    squeeze, (dF, R, mask) = _lanes(dF, R, mask)
    dF, R, mask = dF.contiguous(), R.contiguous(), _f32(mask)
    B, m, T, D = _check("taa_gram", (dF,), (R,), (mask,))
    G = torch.empty((B, T, m, m), dtype=torch.float32, device=dF.device)
    u = torch.empty((B, T, m), dtype=torch.float32, device=dF.device)
    err = _lib().taa_gram_launch(
        dF.data_ptr(), R.data_ptr(), mask.data_ptr(), G.data_ptr(),
        u.data_ptr(), B, m, T, D, _DTYPES[dF.dtype], dF.device.index or 0,
        _build.stream_of(dF))
    _build.raise_on(err, "taa_gram")
    launches["taa_gram"] += 1
    return (G[0], u[0]) if squeeze else (G, u)


def taa_apply(x, R, dX, dF, gamma, mask):
    """x, R (B, T, D); dX, dF (B, m, T, D); gamma (B, T, m); mask (B, T)
    -> (B, T, D) in x's dtype.  Unbatched shapes also taken."""
    squeeze, (dX, dF, x, R, gamma, mask) = _lanes(dX, dF, x, R, gamma, mask)
    x, R, dX, dF = (t.contiguous() for t in (x, R, dX, dF))
    gamma, mask = _f32(gamma), _f32(mask)
    B, m, T, D = _check("taa_apply", (dF, dX), (x, R), (gamma, mask))
    out = torch.empty_like(x)
    err = _lib().taa_apply_launch(
        x.data_ptr(), R.data_ptr(), dX.data_ptr(), dF.data_ptr(),
        gamma.data_ptr(), mask.data_ptr(), out.data_ptr(), B, m, T, D,
        _DTYPES[x.dtype], x.device.index or 0, _build.stream_of(x))
    _build.raise_on(err, "taa_apply")
    launches["taa_apply"] += 1
    return out[0] if squeeze else out


def taa_round(x, R, dX, dF, mask, guard, *, mode: str = "taa",
              lam: float = 1e-8):
    """The whole round in one launch.  x, R (B, T, D); dX, dF (B, m, T, D);
    mask (B, T) window weights; guard (B, T) — rows > 0 get gamma = 0
    (Theorem 3.6 safeguard; zeros for none).  -> (B, T, D) in x's dtype."""
    if mode not in MODES:
        raise ValueError(f"taa_round: unknown mode {mode!r}")
    squeeze, (dX, dF, x, R, mask, guard) = _lanes(dX, dF, x, R, mask, guard)
    x, R, dX, dF = (t.contiguous() for t in (x, R, dX, dF))
    mask, guard = _f32(mask), _f32(guard)
    B, m, T, D = _check("taa_round", (dF, dX), (x, R), (mask, guard))
    out = torch.empty_like(x)
    err = _lib().taa_round_launch(
        x.data_ptr(), R.data_ptr(), dX.data_ptr(), dF.data_ptr(),
        mask.data_ptr(), guard.data_ptr(), out.data_ptr(), B, m, T, D,
        _DTYPES[x.dtype], MODES[mode], float(lam), x.device.index or 0,
        _build.stream_of(x))
    _build.raise_on(err, "taa_round")
    launches["taa_round"] += 1
    return out[0] if squeeze else out
