"""The RG-LRU linear scan h_t = a_t h_{t-1} + b_t, hand-written in CUDA C++
for Hopper (``csrc/rglru_scan.cu``), built at first launch and loaded with
``ctypes``.  Replaces the Pallas TPU kernel of ``repro/kernels/
rglru_scan.py`` (``rglru_scan_kernel``).  Its plain version is
:func:`repro_torch.kernels.ref.rglru_ref`; this wrapper never calls it.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "rglru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches since the last :func:`reset_launches` — one is added where the
#: wrapper launches its kernel, and nowhere else
launches: Dict[str, int] = {"rglru_scan": 0}


def reset_launches() -> None:
    launches["rglru_scan"] = 0


def library_path() -> Path:
    return _build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [P, P, P, I, I, I, I, I, P]
    lib.rglru_scan_launch.restype = I
    return lib


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor, *, bt: int = 256,
                      bc: int = 256) -> torch.Tensor:
    """a, b (B, S, C) float32 or bfloat16 -> h (B, S, C) in a's dtype, with
    h_0 = b_0.  ``bt``/``bc`` (the TPU kernel's tiles) are accepted; the
    CUDA kernel picks its own, and S, C need not be multiples of them."""
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"rglru_scan: a, b must both be (B, S, C), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"rglru_scan: dtypes {a.dtype}, {b.dtype}; both must "
                        f"be float32 or both bfloat16")
    if min(a.shape) < 1:
        raise ValueError(f"rglru_scan: empty shape {tuple(a.shape)}")
    _build.check_on_one_card("rglru_scan", a, b)
    B, S, C = a.shape
    h = torch.empty_like(a)
    err = _lib().rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                   B, S, C, _DTYPES[a.dtype],
                                   a.device.index or 0, _build.stream_of(a))
    _build.raise_on(err, "rglru_scan")
    launches["rglru_scan"] += 1
    return h
