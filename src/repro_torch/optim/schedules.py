"""Learning-rate schedules as step -> lr functions (0-d f32 tensors);
port of ``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    def f(step):
        return _f32(lr)
    return f


def linear_warmup(lr: float, warmup: int):
    def f(step):
        s = _f32(step)
        return lr * torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)
    return f


def cosine_warmup(lr: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return f
