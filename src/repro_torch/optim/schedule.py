"""LR schedules (pure functions of the step counter), in float32 as the
JAX package's ``repro.optim.schedule``."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, warmup: int = 100, total: int = 10_000,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_ratio``; returns a float32
    scale in (0, 1] multiplying the base LR (a 0-d tensor on ``step``'s
    device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    return warm * (min_ratio + (1 - min_ratio) * cos)
