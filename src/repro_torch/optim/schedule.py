"""LR schedules (paper: cosine annealing with linear warmup).

Counterpart of ``repro.optim.schedule``.  ``step`` may be a device
tensor; the result is a 0-d fp32 tensor on the same device, so the
training step reads its LR without a host round trip.
"""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, base_lr: float, warmup_steps: int,
                       total_steps: int, min_ratio: float = 0.1):
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return base_lr * warm * (min_ratio + (1 - min_ratio) * cos)


def constant(step, *, base_lr: float, **_):
    step = torch.as_tensor(step)
    return torch.full((), base_lr, dtype=torch.float32, device=step.device)


SCHEDULES = {"cosine": cosine_with_warmup, "constant": constant}
