"""Learning-rate schedules: step in, a float32 scalar tensor out, with the
reference's float32 arithmetic."""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def warmup_cosine(step, *, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    step = _step(step)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return warm * cos


def linear_decay(step, *, warmup_steps: int, total_steps: int, min_ratio: float = 0.0):
    step = _step(step)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    return warm * (1.0 - (1.0 - min_ratio) * frac)


def constant(step, **_):
    return torch.ones((), dtype=_F32, device=torch.as_tensor(step).device)


SCHEDULES = {"cosine": warmup_cosine, "linear": linear_decay, "constant": constant}
