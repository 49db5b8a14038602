"""LR schedules: plain functions of the step counter (a copy of
``repro/optim/schedule.py``)."""
from __future__ import annotations

import math


def linear_warmup(peak: float, warmup_steps: int):
    def lr(step):
        return peak * min(1.0, step / max(warmup_steps, 1))
    return lr


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def lr(step):
        if step < warmup_steps:
            return peak * min(1.0, step / max(warmup_steps, 1))
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))
    return lr
