"""LR schedules: cosine and warmup-stable-decay, computed in float32."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    s = _step_f32(step)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac * peak_lr + (1 - final_frac) * peak_lr \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.2):
    s = _step_f32(step)
    decay_start = total * (1 - decay_frac)
    warm = peak_lr * s / max(warmup, 1)
    dec = peak_lr * torch.clamp((total - s) / max(total - decay_start, 1),
                                0.0, 1.0)
    return torch.where(s < warmup, warm,
                       torch.where(s < decay_start, peak_lr, dec))
