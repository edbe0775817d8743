"""LR schedules, computed in fp32 as the JAX package computes them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """step -> the learning rate as a 0-d fp32 CPU tensor: linear warmup to
    ``peak_lr`` over ``warmup_steps``, then a cosine down to
    ``min_ratio * peak_lr`` at ``total_steps``."""
    f32 = torch.float32

    def lr(step):
        step = torch.as_tensor(step, dtype=f32)
        warm = peak_lr * torch.clamp((step + 1.0) / max(1, warmup_steps),
                                     max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0, 1)
        # cos of the fp32 angle, correctly rounded to fp32 (XLA's cos is
        # within an ulp of that; torch's fp32 cos is not always)
        ang = torch.tensor(math.pi, dtype=f32) * t
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(ang.double()).float())
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return lr
