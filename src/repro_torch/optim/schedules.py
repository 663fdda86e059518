"""LR schedules (port of ``repro.optim.schedules``): functions of the step
that return the rate as a 0-dim f32 tensor, computed in f32 as the
reference computes it."""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def constant(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def warmup_cosine(lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> Schedule:
    def f(step: int) -> torch.Tensor:
        st = _f32(step)
        warm = lr * torch.clamp_max(st / max(warmup, 1), 1.0)
        frac = torch.clamp((st - warmup) / max(total - warmup, 1), 0, 1)
        cos = lr * (min_ratio + (1 - min_ratio) * 0.5
                    * (1 + torch.cos(math.pi * frac)))
        return torch.where(st < warmup, warm, cos)

    return f


def get(name: str, lr: float, warmup: int = 100,
        total: int = 10000) -> Schedule:
    if name == "constant":
        return constant(lr)
    if name == "warmup_cosine":
        return warmup_cosine(lr, warmup, total)
    raise ValueError(name)
