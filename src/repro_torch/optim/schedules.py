"""Learning-rate schedules (port of ``repro.optim.schedules``): functions
of the 0-d int32 step counter returning a 0-d float32 tensor on its
device."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda count: torch.full_like(count, lr, dtype=torch.float32)


def inverse_time(eta0: float, lam: float):
    """Bottou's SGD schedule: eta_t = eta0 / (1 + lam * eta0 * t)."""
    return lambda count: eta0 / (1.0 + lam * eta0 * count.to(torch.float32))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(count):
        c = count.to(torch.float32)
        # (c+1): step 0 must have a nonzero LR
        warm = peak_lr * torch.clamp((c + 1.0) / max(warmup_steps, 1), max=1.0)
        progress = torch.clamp((c - warmup_steps) /
                               max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress))
        return torch.where(c < warmup_steps, warm, peak_lr * cos)

    return fn
