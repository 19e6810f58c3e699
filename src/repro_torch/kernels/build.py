"""Build and load the port's CUDA kernel libraries, one per source.

Each ``csrc/<name>.cu`` has a plain C interface.  ``build(source)`` compiles
it with ``nvcc`` into ``build/kernels/lib<name>_<hash>.so`` at the
repository root (the hash is of the source, so an edit rebuilds), keeps the
compiler's report (registers, shared memory, spills) beside it as ``.log``,
and ``load(source)`` opens it with ``ctypes``.  Nothing here runs at import
time: a library is built at its kernel's first launch.

The wrappers' shared launch plumbing also lives here: the current stream
of a tensor, the check of a launch's returned ``cudaError_t`` and the
check that every input lies on one CUDA device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = tuple(sorted(CSRC.glob("*.cu")))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found under {home}/bin or on PATH")
    return found


def library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build(source: Path) -> Path:
    """Compile ``source`` into its shared library unless this version's
    build is already there.  Raises with the compiler's errors if it
    fails."""
    return build_all((source,))[source]


def build_all(sources=SOURCES) -> dict:
    """Build every source that is not built yet, one ``nvcc`` each, all
    started together.  Returns {source: library path}; raises with the
    compiler's errors if any build failed."""
    todo = [s for s in sources if not library_path(s).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for source in todo:
        out = library_path(source)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        procs.append((source, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, out, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{log[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {s: library_path(s) for s in sources}


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def check_on_one_card(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor contiguous and on the first one's CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on one CUDA "
                             f"device, got {t.device} and {dev}")
