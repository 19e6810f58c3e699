"""The Mamba2 SSD scan (single group), hand-written in CUDA C++ for Hopper
(``csrc/ssd_scan.cu``), built at first launch and loaded with ``ctypes``.
Replaces the Pallas TPU kernel of ``repro/kernels/ssd_scan.py``
(``ssd_scan``).  Its plain version is :func:`repro_torch.kernels.ref.
ssd_ref`; this wrapper never calls it.

The kernel runs the chunked form over chunks of :data:`CHUNK` steps, its
products on the tensor cores in 3xTF32, in two launches, each counted
under its own key in :data:`launches`: ``ssd_scan`` (every chunk in
parallel: the intra-chunk output and the chunk-local state) and
``ssd_state_pass`` (the chunks in order: the inter-chunk output, the state
entering the next chunk, the final state).  :func:`chunk_plan` gives the
chunks and launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "ssd_scan.cu"
MAX_P, MAX_N = 64, 128
#: the kernel's own chunk (``kQ`` in the source), whatever ``chunk`` says
CHUNK = 64

#: launches since the last :func:`reset_launches` — one is added where the
#: wrapper launches a kernel, and nowhere else
launches: Dict[str, int] = {"ssd_scan": 0, "ssd_state_pass": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def chunk_plan(s: int) -> dict:
    """Chunks of a sequence of ``s`` steps and the launches of one call."""
    if s < 1:
        raise ValueError(f"ssd_scan: empty sequence s={s}")
    chunks = -(-s // CHUNK)
    return dict(chunk=CHUNK, chunks=chunks,
                launches={"ssd_scan": 1, "ssd_state_pass": 1})


def library_path() -> Path:
    return _build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I,
                                     I, I, P]
    lib.ssd_pass_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
    lib.ssd_chunk_size.argtypes = []
    for fn in (lib.ssd_chunk_size, lib.ssd_chunk_launch, lib.ssd_pass_launch):
        fn.restype = I
    if lib.ssd_chunk_size() != CHUNK:
        raise RuntimeError(f"ssd_scan: the library's chunk "
                           f"{lib.ssd_chunk_size()} is not {CHUNK}")
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """x (b, s, h, p); dt (b, s, h) post-softplus; A (h,) negative; B, C
    (b, s, n) single group; all float32, p <= 64, n <= 128 -> (y (b, s, h,
    p) float32, final_state (b, h, p, n) float32).  ``chunk`` (the TPU
    kernel's) is accepted; the CUDA kernel uses its own :data:`CHUNK` and s
    need not be a multiple of either."""
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"ssd_scan: x must be (b, s, h, p) and B, C (b, s, "
                         f"n), got {tuple(x.shape)}, {tuple(B.shape)}")
    bsz, s, h, p = x.shape
    n = B.shape[-1]
    for name, t, want in (("dt", dt, (bsz, s, h)), ("A", A, (h,)),
                          ("B", B, (bsz, s, n)), ("C", C, (bsz, s, n))):
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_scan: {name} must be {want}, got "
                             f"{tuple(t.shape)}")
    if min(bsz, s, h, p, n) < 1 or p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan: p={p}, n={n} must lie in [1, {MAX_P}], "
                         f"[1, {MAX_N}]")
    for t in (x, dt, A, B, C):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: inputs must be float32, got {t.dtype}")
    _build.check_on_one_card("ssd_scan", x, dt, A, B, C)
    plan = chunk_plan(s)
    nc = plan["chunks"]
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    # the chunk-local states; the inclusive sums of dt A within each chunk
    states = torch.empty((bsz, h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    cums = torch.empty((bsz, h, nc, CHUNK), dtype=torch.float32,
                       device=x.device)
    # 16-byte staging copies where every row start is 16-byte aligned
    vec = int(p % 4 == 0 and n % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, B, C)))
    lib, dev, stream = _lib(), x.device.index or 0, _build.stream_of(x)
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), cums.data_ptr(), bsz, s, h, p, n,
        vec, dev, stream)
    _build.raise_on(err, "ssd_scan")
    launches["ssd_scan"] += 1
    err = lib.ssd_pass_launch(C.data_ptr(), states.data_ptr(),
                              cums.data_ptr(), y.data_ptr(), state.data_ptr(),
                              bsz, s, h, p, n, vec, dev, stream)
    _build.raise_on(err, "ssd_state_pass")
    launches["ssd_state_pass"] += 1
    return y, state
