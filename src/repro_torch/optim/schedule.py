"""Learning-rate schedules (functions of the step counter, an int tensor)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        frac = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * (min_frac + (1 - min_frac) * cos)

    return lr


def linear_warmup_cosine(
    base_lr: float, warmup_steps: int, total_steps: int, min_frac: float = 0.1
):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), min_frac)

    def lr(step):
        s = step.float()
        warm = base_lr * s / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return lr
