"""GQA flash decode, hand-written in CUDA C++ for Hopper
(``csrc/flash_decode.cu``), built at first launch and loaded with
``ctypes``.  Replaces the Pallas TPU kernel of ``repro/kernels/
flash_decode.py`` (``flash_decode``), int8 cache included.  Its plain
versions are :func:`repro_torch.kernels.ref.decode_ref` and, for an int8
cache, :func:`~repro_torch.kernels.ref.decode_int8_ref`; this wrapper never
calls them.

The cache of each (batch row, KV head) is split into contiguous key ranges
(:func:`split_plan`), one block each; a second launch merges the ranges'
partial softmax states in range order when there is more than one.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "flash_decode.cu"
MAX_G = 16
MAX_D = 256
#: the card's SMs (H100 SXM); the split pass aims at two blocks for each
SMS = 132
#: keys of a range are a multiple of this (4 warps x 4 rows a step), and
#: at most MAX_CHUNK
CHUNK_STEP = 16
MAX_CHUNK = 512
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2

#: launches since the last :func:`reset_launches` — one is added where the
#: wrapper launches its kernel, and nowhere else
launches: Dict[str, int] = {"flash_decode": 0, "flash_decode_combine": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def split_plan(B: int, KV: int, T: int, D: int) -> Tuple[int, int]:
    """-> (splits, chunk): the cache's T keys cut into ``splits`` ranges of
    ``chunk`` keys (the last may be shorter), so that the split pass has at
    least about 2 x :data:`SMS` blocks of B * KV * splits, and no range
    holds more than :data:`MAX_CHUNK` keys (a block's serial chain, and the
    imbalance between rows of ragged lengths, stay short).  A range holds
    at least ``CHUNK_STEP`` keys and 4096 elements (``chunk * D``), so a
    block streams enough to repay its start and its partial state."""
    if min(B, KV, T, D) < 1:
        raise ValueError(f"split_plan: empty shape B={B} KV={KV} T={T} D={D}")
    target = 2 * SMS
    least = max(CHUNK_STEP, _round_up(-(-4096 // D), CHUNK_STEP))
    if T <= least:
        return 1, T
    want = max(-(-target // (B * KV)), -(-T // MAX_CHUNK))
    chunk = max(least, _round_up(-(-T // want), CHUNK_STEP))
    while B * KV * -(-T // chunk) < target and chunk > least:
        chunk -= CHUNK_STEP
    splits = -(-T // chunk)
    return (1, T) if splits == 1 else (splits, chunk)


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def library_path() -> Path:
    return _build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I,
                                        I, I, I, I, I, I, I, I, P]
    lib.flash_decode_launch.restype = I
    lib.flash_decode_combine_launch.argtypes = [P, P, P, P, I, I, I, I, I, I,
                                                I, P]
    lib.flash_decode_combine_launch.restype = I
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
    if D > MAX_D:
        raise ValueError(f"flash_decode: head dim {D} > {MAX_D}")
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
    G = H // KV
    splits, chunk = split_plan(B, KV, T, D)
    qcode = _Q_DTYPES[q.dtype]
    dev, stream = q.device.index or 0, _build.stream_of(q)
    ptrs = [None, None, None]
    if splits > 1:
        # one float32 scratch: acc (B, KV, splits, G, D), then m and l
        # (B, KV, splits, G); kept referenced until both launches are queued
        n = B * KV * splits * G
        part = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        base = part.data_ptr()
        ptrs = [base, base + 4 * n * D, base + 4 * n * (D + 1)]
    err = _lib().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, lengths.data_ptr(),
        out.data_ptr(), *ptrs, B, H, KV, T, D, chunk, splits, qcode, code,
        dev, stream)
    _build.raise_on(err, "flash_decode")
    launches["flash_decode"] += 1
    if splits > 1:
        err = _lib().flash_decode_combine_launch(
            *ptrs, out.data_ptr(), B, H, KV, D, splits, qcode, dev, stream)
        _build.raise_on(err, "flash_decode_combine")
        launches["flash_decode_combine"] += 1
    return out
