"""Flash attention (forward), hand-written in CUDA C++ for Hopper, built at
first launch and loaded with ``ctypes``.  Replaces the Pallas TPU kernel of
``repro/kernels/flash_attention.py`` (``flash_attention``).  Its plain
version is :func:`repro_torch.kernels.ref.attention_ref`; this wrapper
never calls it.

Two kernels, chosen by dtype and head dim (:func:`attention_path`):
bfloat16 rows of whole 16-byte vectors go to the tensor cores through
wgmma + TMA (``csrc/flash_attention_tc.cu``), everything else (float32,
and bfloat16 at other head dims) to the tensor cores through mma.sync in
TF32, float32 operands split 3xTF32 (``csrc/flash_attention.cu``; its
tiles in :func:`tf32_tiles`).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "flash_attention.cu"
SOURCE_TC = _build.CSRC / "flash_attention_tc.cu"
MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches since the last :func:`reset_launches` — one is added where the
#: wrapper launches a kernel, and nowhere else: "flash_attention" counts
#: every launch, "flash_attention_tc" those of the tensor-core kernel
launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def attention_path(dtype: torch.dtype, D: int) -> str:
    """Which kernel a call takes: "tensor_cores" (wgmma + TMA) for bfloat16
    whose rows are whole 16-byte vectors (D % 8 == 0, as TMA needs), else
    "tensor_cores_tf32" (mma.sync in TF32: float32, and bfloat16 at other
    D)."""
    if dtype == torch.bfloat16 and D % 8 == 0:
        return "tensor_cores"
    return "tensor_cores_tf32"


def tf32_tiles(D: int) -> tuple:
    """(query rows, keys) of a tile of the TF32 kernel at head dim ``D``:
    4 warps of two 16-row m-tiles (128 queries) up to D = 72, of one (64)
    above; 32 keys a K and V tile."""
    return (128 if D <= 72 else 64), 32


def live_key_tiles(qt: int, S: int, T: int, causal: bool, window: int, *,
                   bq: int = 128, bk: int = 128) -> range:
    """The key tiles (of ``bk`` keys) that query tile ``qt`` (of ``bq``
    rows) loads: those where some (query, key) pair survives the causal and
    window masks, with queries right-aligned (the TPU kernel's block-level
    skip, flash_attention.py:46-54 of the JAX package).  Both kernels
    compute the same range from the same arithmetic, each with its own
    tiles."""
    q_min = qt * bq + T - S
    q_max = min(qt * bq + bq, S) - 1 + T - S
    end = -(-T // bk)
    if causal:
        end = min(end, 0 if q_max < 0 else q_max // bk + 1)
    begin = (q_min - window + 1) // bk if window and q_min - window + 1 > 0 \
        else 0
    return range(begin, max(begin, end))


def library_path() -> Path:
    return _build.library_path(SOURCE)


def library_path_tc() -> Path:
    return _build.library_path(SOURCE_TC)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I,
                                           P]
    lib.flash_attention_launch.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib_tc() -> ctypes.CDLL:
    lib = _build.load(SOURCE_TC)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_tc_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, I,
                                              P]
    lib.flash_attention_tc_launch.restype = I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, H, T, D), float32 or bfloat16, D <= 256 ->
    (B, H, S, D) in q's dtype.  Queries right-aligned when S < T.
    ``bq``/``bk`` (the TPU kernel's tiles) are accepted; the CUDA kernels
    pick their own, and S, T need not be multiples of them.  On the tensor
    cores every tensor must be 16-byte aligned (TMA)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, H, S, D) and k, v "
                         f"(B, H, T, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, H, S, D = q.shape
    T = k.shape[2]
    if tuple(k.shape) != (B, H, T, D) or tuple(v.shape) != (B, H, T, D):
        raise ValueError(f"flash_attention: k, v must be ({B}, {H}, T, {D}) "
                         f"alike, got {tuple(k.shape)}, {tuple(v.shape)}")
    if min(B, H, S, T, D) < 1 or D > MAX_D:
        raise ValueError(f"flash_attention: empty shape or head dim {D} > "
                         f"{MAX_D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; all float32 or all bfloat16")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    _build.check_on_one_card("flash_attention", q, k, v)
    out = torch.empty_like(q)
    dev, stream = q.device.index or 0, _build.stream_of(q)
    if attention_path(q.dtype, D) == "tensor_cores":
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: the tensor-core kernel needs "
                             "16-byte aligned q, k, v (TMA)")
        err = _lib_tc().flash_attention_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H,
            S, T, D, int(bool(causal)), int(window), dev, stream)
        _build.raise_on(err, "flash_attention_tc")
        launches["flash_attention_tc"] += 1
    else:
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H,
            S, T, D, int(bool(causal)), int(window), _DTYPES[q.dtype], dev,
            stream)
        _build.raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
