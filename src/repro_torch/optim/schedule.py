"""Learning-rate schedules as ``step -> lr`` callables on a () int tensor,
float32 results (the reference's ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch

__all__ = ["constant_schedule", "cosine_schedule", "warmup_cosine"]


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(peak_lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return fn
