"""The RG-LRU linear scan h_t = a_t h_{t-1} + b_t, hand-written in CUDA C++
for Hopper (``csrc/rglru_scan.cu``), built at first launch and loaded with
``ctypes``.  Replaces the Pallas TPU kernel of ``repro/kernels/
rglru_scan.py`` (``rglru_scan_kernel``).  Its plain version is
:func:`repro_torch.kernels.ref.rglru_ref`; this wrapper never calls it.

The kernel reads a and b once: tiles of (batch, 16 bytes of channels x 8
threads, 256 steps) are walked in segment-major order by one cooperative
grid, and each tile takes its predecessor's final state from a chain of
64-bit (tag, state) words in device memory (:func:`tile_plan`).
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

SEGMENT = 256        # steps a tile
SUB_STEPS = 8        # steps a thread holds; 32 threads' maps scanned a tile
GROUPS = 8           # 16-byte channel groups a tile row
_TAGS = 1 << 32

#: launches since the last :func:`reset_launches` — one is added where the
#: wrapper launches its kernel, and nowhere else
launches: Dict[str, int] = {"rglru_scan": 0}
#: the last launch's cooperative grid: CTAs, tiles, CTAs co-resident
last_grid: Dict[str, int] = {}
# per (device, stream): the chain's (tag, state) words and the next tag
_chains: Dict[tuple, list] = {}


def reset_launches() -> None:
    launches["rglru_scan"] = 0


def tile_plan(B: int, S: int, C: int, elem_bytes: int) -> dict:
    """How the kernel cuts (B, S, C): tiles of ``SEGMENT`` steps by
    ``channels`` (8 x 16 bytes), numbered segment-major (tile = segment *
    chains + batch * channel_blocks + channel_block); a tile's predecessor
    is tile - chains, the same channels' previous segment."""
    if min(B, S, C) < 1 or elem_bytes not in (2, 4):
        raise ValueError(f"tile_plan: empty shape ({B}, {S}, {C}) or element "
                         f"size {elem_bytes}")
    channels = GROUPS * 16 // elem_bytes
    blocks = -(-C // channels)
    segments = -(-S // SEGMENT)
    return dict(channels=channels, steps=SEGMENT, channel_blocks=blocks,
                segments=segments, chains=B * blocks,
                tiles=B * blocks * segments)


def _chain_words(t: torch.Tensor, n: int, tags: int) -> tuple:
    """The (tag, state) words of ``t``'s device and stream (at least ``n``)
    and the first of ``tags`` fresh tags: every word's tag is below it.
    Zeroed once, and again when the tags would wrap."""
    key = (t.device.index or 0, _build.stream_of(t))
    words, tag = _chains.get(key, (None, 1))
    if words is None or words.numel() < n or tag + tags >= _TAGS:
        words, tag = torch.zeros(max(n, 1), dtype=torch.int64,
                                 device=t.device), 1
    _chains[key] = [words, tag + tags]
    return words, tag


def library_path() -> Path:
    return _build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [P, P, P, P, ctypes.c_uint, P, I, I, I,
                                      I, I, P]
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
    plan = tile_plan(B, S, C, a.element_size())
    words, tag = _chain_words(a, B * C, plan["segments"] + 1)
    info = (ctypes.c_int * 3)()
    err = _lib().rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                   words.data_ptr(), tag, info, B, S, C,
                                   _DTYPES[a.dtype], a.device.index or 0,
                                   _build.stream_of(a))
    _build.raise_on(err, "rglru_scan")
    launches["rglru_scan"] += 1
    last_grid.update(ctas=info[0], tiles=info[1], co_resident=info[2])
    return h
