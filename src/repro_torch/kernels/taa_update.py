"""The three Anderson/TAA update kernels, hand-written in CUDA C++ for
Hopper (``csrc/taa_update.cu``), built with ``nvcc`` at first use and
loaded with ``ctypes``.

They replace the Pallas TPU kernels of ``repro/kernels/taa_update.py``:

  taa_gram   per-row masked Gram blocks G_t = (w dF_t)(w dF_t)^T, u_t =
             (w dF_t)(w R_t) in one launch over (lane, row, D-tile)
             tiles, a row's tiles in one thread block cluster whose first
             CTA sums them in tile order          [replaces taa_gram]
             (:func:`gram_plan` gives its tiles and grid)
  taa_apply  x_t + R_t - (dX_t + dF_t)^T gamma_t on rows with mask > 0
                                                   [replaces taa_apply]
  taa_round  the whole round in one cooperative launch over (lane, row,
             D-tile) tiles: Gram partials, a grid barrier, suffix (taa) /
             global (aa; aa+ Gram only) sums + ridge, pivot-free
             Gauss-Jordan solves, guard rows gamma = 0, apply
                                                   [replaces taa_round]
             (:func:`round_plan` gives its tiles and grid)

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
#: elements of D in one tile of taa_gram and taa_round (``kRoundTile``)
ROUND_TILE = 512
#: bytes of taa_gram's vector loads, one a stream per thread
#: (``kGramVecBytes``): 4 float32 or 8 bf16
GRAM_VEC_BYTES = 16
#: taa_gram's CTAs a row (one thread block cluster), at most
#: (``kGramCluster``)
GRAM_CLUSTER = 8
MODES = {"taa": 0, "aa": 1, "aa+": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches per kernel since the last :func:`reset_launches` — one is added
#: where a wrapper launches its kernel, and nowhere else
launches: Dict[str, int] = {"taa_gram": 0, "taa_apply": 0, "taa_round": 0}


#: taa_round's grid at its last launch: CTAs launched, tiles, and the CTAs
#: the card holds at once for that kernel (from ``round_plan`` and the
#: launcher's occupancy query)
last_round_grid: Dict[str, int] = {}

#: taa_gram's grid at its last launch: CTAs, tiles per row, threads a CTA
#: and CTAs a cluster (from the launcher; ``gram_plan`` gives the same)
last_gram_grid: Dict[str, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def round_partials(B: int, m: int, T: int, D: int) -> Tuple[int, ...]:
    """Shape of taa_round's float32 scratch (B, NV, T, tiles_per_row): per
    tile, NV = m(m+1)/2 Gram entries of G and m of u."""
    return (B, m * (m + 1) // 2 + m, T, -(-D // ROUND_TILE))


def round_plan(B: int, m: int, T: int, D: int, co_resident: int) -> dict:
    """taa_round's cooperative grid: (lane, row, D-tile) tiles of
    ``ROUND_TILE`` floats, tile id ((b T + t) tiles_per_row + j); as many
    CTAs as the card holds at once (``co_resident``) or as there are tiles,
    whichever is fewer, each walking the tiles grid-stride (CTA c takes c,
    c + ctas, ...).  ``partials`` is the float32 scratch (B, NV, T,
    tiles_per_row) the wrapper allocates."""
    if min(B, m, T, D) < 1 or co_resident < 1:
        raise ValueError(f"taa_round: empty shape or grid {(B, m, T, D)}, "
                         f"{co_resident}")
    partials = round_partials(B, m, T, D)
    tiles = B * T * partials[-1]
    return dict(tile=ROUND_TILE, tiles_per_row=partials[-1], tiles=tiles,
                ctas=min(tiles, co_resident), co_resident=co_resident,
                partials=partials)


def gram_plan(B: int, m: int, T: int, D: int, elem_size: int = 4) -> dict:
    """taa_gram's grid: (lane, row, D-tile) tiles of ``ROUND_TILE``
    elements; a row's tiles go to one thread block cluster of ``cluster`` =
    min(tiles_per_row, ``GRAM_CLUSTER``) CTAs, CTA (b T + t) cluster + c
    taking tiles c, c + cluster, ...; each thread one ``GRAM_VEC_BYTES``
    vector of every stream (``vector`` elements of ``elem_size`` bytes), so
    ``threads`` = ROUND_TILE / vector.  ``sums_bytes`` is the shared memory
    the cluster's first CTA gathers the row's tile sums in."""
    if min(B, m, T, D) < 1 or elem_size not in (2, 4):
        raise ValueError(f"taa_gram: empty shape {(B, m, T, D)} or element "
                         f"size {elem_size}")
    tpr = -(-D // ROUND_TILE)
    cluster = min(tpr, GRAM_CLUSTER)
    vector = GRAM_VEC_BYTES // elem_size
    return dict(tile=ROUND_TILE, tiles_per_row=tpr, tiles=B * T * tpr,
                cluster=cluster, ctas=B * T * cluster, vector=vector,
                threads=ROUND_TILE // vector,
                sums_bytes=4 * tpr * (m * (m + 1) // 2 + m))


def library_path() -> Path:
    return _build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.taa_gram_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.taa_apply_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.taa_round_launch.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                     I, F, I, P]
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
    info = (ctypes.c_int * 4)()
    err = _lib().taa_gram_launch(
        dF.data_ptr(), R.data_ptr(), mask.data_ptr(), G.data_ptr(),
        u.data_ptr(), info, B, m, T, D, _DTYPES[dF.dtype],
        dF.device.index or 0, _build.stream_of(dF))
    _build.raise_on(err, "taa_gram")
    launches["taa_gram"] += 1
    last_gram_grid.update(ctas=info[0], tiles_per_row=info[1],
                          threads=info[2], cluster=info[3])
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
    """The whole round in one cooperative launch.  x, R (B, T, D); dX, dF
    (B, m, T, D); mask (B, T) window weights; guard (B, T) — rows > 0 get
    gamma = 0 (Theorem 3.6 safeguard; zeros for none).  -> (B, T, D) in
    x's dtype.  Any T: the Gram partials live in a device scratch."""
    if mode not in MODES:
        raise ValueError(f"taa_round: unknown mode {mode!r}")
    squeeze, (dX, dF, x, R, mask, guard) = _lanes(dX, dF, x, R, mask, guard)
    x, R, dX, dF = (t.contiguous() for t in (x, R, dX, dF))
    mask, guard = _f32(mask), _f32(guard)
    B, m, T, D = _check("taa_round", (dF, dX), (x, R), (mask, guard))
    out = torch.empty_like(x)
    part = torch.empty(round_partials(B, m, T, D), dtype=torch.float32,
                       device=x.device)
    info = (ctypes.c_int * 3)()
    err = _lib().taa_round_launch(
        x.data_ptr(), R.data_ptr(), dX.data_ptr(), dF.data_ptr(),
        mask.data_ptr(), guard.data_ptr(), out.data_ptr(), part.data_ptr(),
        info, B, m, T, D, _DTYPES[x.dtype], MODES[mode], float(lam),
        x.device.index or 0, _build.stream_of(x))
    _build.raise_on(err, "taa_round")
    launches["taa_round"] += 1
    last_round_grid.update(ctas=info[0], tiles=info[1],
                           co_resident=info[2])
    return out[0] if squeeze else out
