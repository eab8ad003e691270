"""LR schedules (cosine with linear warmup, the LM-pretraining standard).

The port of ``repro/optim/schedules.py``: each schedule maps the step
count (an int tensor) to the learning rate as an fp32 tensor on the
count's device, so the optimizer's update never waits on the host.
"""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup_steps)
        t = torch.clamp((step - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac
                         + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
