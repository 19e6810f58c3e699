"""Learning-rate schedules (warmup + cosine decay), in float32 as the JAX
package's ``repro.optim.schedule`` computes them."""
from __future__ import annotations

import math

import torch


def lr_schedule(step, *, base_lr: float, warmup_steps: int = 100,
                total_steps: int = 10_000, min_ratio: float = 0.1):
    """Learning rate at ``step`` (an int or a tensor): a 0-d float32 tensor
    on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, base_lr * cos)
