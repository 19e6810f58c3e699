"""GQA flash decode, hand-written in CUDA C++ for Hopper
(``csrc/flash_decode.cu``), built at first launch and loaded with
``ctypes``.  Replaces the Pallas TPU kernel of ``repro/kernels/
flash_decode.py`` (``flash_decode``), int8 cache included.  Its plain
versions are :func:`repro_torch.kernels.ref.decode_ref` and, for an int8
cache, :func:`~repro_torch.kernels.ref.decode_int8_ref`; this wrapper never
calls them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "flash_decode.cu"
MAX_G = 16
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2

#: launches since the last :func:`reset_launches` — one is added where the
#: wrapper launches its kernel, and nowhere else
launches: Dict[str, int] = {"flash_decode": 0}


def reset_launches() -> None:
    launches["flash_decode"] = 0


def library_path() -> Path:
    return _build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I,
                                        I, I, P]
    lib.flash_decode_launch.restype = I
    return lib


def _check(q, k_cache, v_cache, lengths, k_scale, v_scale):
    """Validate shapes and dtypes, then that every tensor is contiguous and
    on one CUDA device.  Returns (B, H, KV, T, D, cache dtype code)."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"flash_decode: q must be (B, H, D) and the caches "
                         f"(B, T, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    B, H, D = q.shape
    _, T, KV, _ = k_cache.shape
    if tuple(k_cache.shape) != (B, T, KV, D) or \
            tuple(v_cache.shape) != (B, T, KV, D) or min(B, H, T, KV, D) < 1:
        raise ValueError(f"flash_decode: caches must be (B={B}, T, KV, D={D}) "
                         f"alike, got {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    if H % KV or not 1 <= H // KV <= MAX_G:
        raise ValueError(f"flash_decode: H={H} must be a multiple G of KV={KV}"
                         f" with G <= {MAX_G}")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"flash_decode: lengths must be int32 ({B},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"flash_decode: q dtype {q.dtype} not float32 or "
                        f"bfloat16")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("flash_decode: k and v caches differ in dtype")
    scales = ()
    if k_cache.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("flash_decode: an int8 cache needs k_scale and "
                             "v_scale")
        for s in (k_scale, v_scale):
            if tuple(s.shape) != (B, T, KV) or s.dtype != torch.float32:
                raise ValueError(f"flash_decode: scales must be float32 "
                                 f"{(B, T, KV)}, got {s.dtype} "
                                 f"{tuple(s.shape)}")
        scales, code = (k_scale, v_scale), _INT8
    elif k_cache.dtype == q.dtype:
        if k_scale is not None or v_scale is not None:
            raise ValueError("flash_decode: scales are for an int8 cache only")
        code = _Q_DTYPES[q.dtype]
    else:
        raise TypeError(f"flash_decode: cache dtype {k_cache.dtype} is neither"
                        f" q's ({q.dtype}) nor int8")
    _build.check_on_one_card("flash_decode", q, k_cache, v_cache, lengths,
                             *scales)
    return B, H, KV, T, D, code


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor, *,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 bk: int = 256) -> torch.Tensor:
    """q (B, H, D); k/v_cache (B, T, KV, D); lengths (B,) integer -> (B, H, D)
    in q's dtype.  With int8 caches pass k_scale/v_scale (B, T, KV) float32:
    the kernel reads 1 byte per element and dequantises in registers.
    ``bk`` (the TPU kernel's tile) is accepted; the CUDA kernel picks its
    own and T need not be a multiple of it.  A row with length 0 gives 0
    (the TPU kernel's value), not the plain version's mean of v."""
    if lengths.dtype in (torch.int64, torch.int16, torch.uint8):
        lengths = lengths.to(torch.int32)       # as the JAX wrapper casts
    B, H, KV, T, D, code = _check(q, k_cache, v_cache, lengths, k_scale,
                                  v_scale)
    out = torch.empty_like(q)
    quant = code == _INT8
    err = _lib().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, lengths.data_ptr(),
        out.data_ptr(), B, H, KV, T, D, _Q_DTYPES[q.dtype], code,
        q.device.index or 0, _build.stream_of(q))
    _build.raise_on(err, "flash_decode")
    launches["flash_decode"] += 1
    return out
