"""LR schedules as step -> lr callables, the port of
``repro.optim.schedules``.

Each returns a 0-d float32 tensor on the CPU, computed in float32 as
JAX computes it (a Python float would round once, at the end, and drift
from JAX's value by ~1e-8). ``step`` is an int or an integer tensor.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=F32)


def cosine_decay(lr: float, steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step), max=steps) / steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return f


def linear_warmup_cosine(lr: float, warmup: int, steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(steps - warmup, 1), final_frac)

    def f(step):
        step = _f32(step)
        wu = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, wu, cos(step - warmup))

    return f
