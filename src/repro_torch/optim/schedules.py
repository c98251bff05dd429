"""Learning-rate schedules as step -> lr callables.

A step is an int or an integer tensor; the lr comes back as a float32
0-dim tensor on the step's device (the CPU for an int), computed in
float32 as the reference computes it.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    def f(step):
        return torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)

    return f


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_step(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)

    return f


def linear_warmup_cosine(
    peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
):
    cos = cosine_schedule(peak_lr, max(1, total_steps - warmup_steps), final_frac)

    def f(step):
        s = _step(step)
        warm = peak_lr * s / max(1, warmup_steps)
        return torch.where(s < warmup_steps, warm, cos(torch.as_tensor(step) - warmup_steps))

    return f
