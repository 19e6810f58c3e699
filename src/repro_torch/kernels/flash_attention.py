"""Flash attention (forward), hand-written in CUDA C++ for Hopper
(``csrc/flash_attention.cu``), built at first launch and loaded with
``ctypes``.  Replaces the Pallas TPU kernel of ``repro/kernels/
flash_attention.py`` (``flash_attention``).  Its plain version is
:func:`repro_torch.kernels.ref.attention_ref`; this wrapper never calls it.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "flash_attention.cu"
MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches since the last :func:`reset_launches` — one is added where the
#: wrapper launches its kernel, and nowhere else
launches: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def library_path() -> Path:
    return _build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I,
                                           P]
    lib.flash_attention_launch.restype = I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, H, T, D), float32 or bfloat16, D <= 256 ->
    (B, H, S, D) in q's dtype.  Queries right-aligned when S < T.
    ``bq``/``bk`` (the TPU kernel's tiles) are accepted; the CUDA kernel
    picks its own, and S, T need not be multiples of them."""
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
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S, T,
        D, int(bool(causal)), int(window), _DTYPES[q.dtype],
        q.device.index or 0, _build.stream_of(q))
    _build.raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
