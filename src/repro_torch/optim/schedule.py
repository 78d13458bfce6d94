"""Learning-rate schedules (counterpart of ``repro.optim.schedule``):
warmup + cosine decay, the LM default, and a constant.  ``step`` is an
integer tensor; the rate comes back as an f32 scalar tensor on its
device."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step).float()
    warm = peak_lr * s / max(1, warmup_steps)
    prog = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                       0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step), peak_lr,
                           dtype=torch.float32)
