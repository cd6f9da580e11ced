"""Learning-rate schedules (port of ``repro.optim.schedules``): pure
functions of the step counter.

The step is a 0-d integer tensor on the CPU (the optimizers keep it
there), and each schedule returns a 0-d float32 tensor on the CPU, as the
reference returns a float32 scalar: reading it never waits for the card.
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def constant(lr: float):
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = lr * step / max(warmup_steps, 1)
        t = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn
