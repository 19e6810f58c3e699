"""What the plain references share: float32 without TF32, and the
timestep embedding both denoisers take."""
from __future__ import annotations

import contextlib
import math

import torch

TEMB_DIM = 256


@contextlib.contextmanager
def exact_float32():
    """float32 products in full float32: TF32 off for matmuls and
    convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def timestep_embedding(t: torch.Tensor, dim: int = TEMB_DIM) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) float32: cos, then sin, of
    t * 10000^(-i/half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float64, device=t.device) / half)
    ang = t.double()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).float()
