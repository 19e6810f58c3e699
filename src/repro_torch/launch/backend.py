"""Backend tuning switches for the card: TF32 for float32 matmuls and
convolutions, behind ``serve.py --backend-tune``.

The JAX package's ``repro.launch.backend`` merges XLA:GPU serving flags
into ``XLA_FLAGS``; XLA on a GPU already runs float32 dots at default
precision in TF32.  PyTorch does not: a float32 matmul on the card runs
in full float32 unless ``torch.backends.cuda.matmul.allow_tf32`` is set
(and the float32 matmul precision is "high"), while cuDNN's convolutions
read ``torch.backends.cudnn.allow_tf32``.  So the switches that
``--backend-tune`` sets here are those three, and only on a CUDA device:
on a host without one this is a no-op, as the reference's is off a GPU.
TF32 keeps about three decimal digits, so a tuned run is held against a
sequential run under the same switches, not against float32.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

#: the switches ``--backend-tune`` sets on a CUDA device
TUNED: Dict[str, object] = {
    "cuda_matmul_allow_tf32": True,
    "cudnn_allow_tf32": True,
    "float32_matmul_precision": "high",
}


def detect_platform(cuda_available: Optional[bool] = None) -> str:
    """"gpu" iff a CUDA device is there (``torch.cuda.is_available()``,
    unless ``cuda_available`` says), else "other"."""
    if cuda_available is None:
        cuda_available = torch.cuda.is_available()
    return "gpu" if cuda_available else "other"


def read_settings() -> Dict[str, object]:
    """The switches' current values, under :data:`TUNED`'s names."""
    return {
        "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def write_settings(settings: Dict[str, object]) -> None:
    """Sets the switches (a dict as :func:`read_settings` gives it)."""
    torch.backends.cuda.matmul.allow_tf32 = bool(
        settings["cuda_matmul_allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(settings["cudnn_allow_tf32"])
    torch.set_float32_matmul_precision(
        str(settings["float32_matmul_precision"]))


def tuned_settings(current: Dict[str, object],
                   platform: str) -> Optional[Dict[str, object]]:
    """The switches ``--backend-tune`` would leave set, or None for a
    no-op (not a GPU).  A pure function of its inputs."""
    if platform != "gpu":
        return None
    return {**current, **TUNED}


def apply_backend_tune(argv, platform: Optional[str] = None) -> bool:
    """When ``--backend-tune`` is in ``argv`` and the platform is a GPU
    (:func:`detect_platform` unless given), set the :data:`TUNED`
    switches.  Returns True iff it changed one."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--backend-tune", action="store_true")
    args, _ = parser.parse_known_args(argv)
    if not args.backend_tune:
        return False
    current = read_settings()
    tuned = tuned_settings(current, platform or detect_platform())
    if tuned is None or tuned == current:
        return False
    write_settings(tuned)
    return True
