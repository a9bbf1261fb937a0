"""LR schedules (pure functions of step), port of ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up over ``warmup`` steps, then a cosine decay to 0 at
    ``total``; ``lr(step)`` is a float32 scalar tensor on the step's
    device (an int step: the CPU), computed in float32 as the reference
    computes it."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr
