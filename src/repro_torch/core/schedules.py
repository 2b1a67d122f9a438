"""Learning-rate schedules (paper §4: cosine with 2k warmup, 0.05x floor).

Each schedule maps an integer step to a 0-d float32 CPU tensor, computed
with the reference's f32 operation order.  Python-float constants are folded
in double precision first, as the reference's weakly typed constants are.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def constant(peak_lr: float):
    def sched(step):
        return torch.tensor(peak_lr, dtype=F32)

    return sched


def cosine_with_warmup(
    peak_lr: float,
    total_steps: int,
    warmup_steps: int = 2000,
    final_frac: float = 0.05,
):
    """Linear warmup to ``peak_lr`` then cosine decay to ``final_frac * peak_lr``."""
    min_lr = final_frac * peak_lr
    half_span = 0.5 * (peak_lr - min_lr)
    pi = torch.tensor(math.pi, dtype=F32)

    def sched(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = peak_lr * (step + 1.0) / max(warmup_steps, 1)
        denom = torch.tensor(float(max(total_steps - warmup_steps, 1)), dtype=F32)
        progress = torch.clamp((step - warmup_steps) / denom, 0.0, 1.0)
        cos = min_lr + half_span * (1.0 + torch.cos(pi * progress))
        return torch.where(step < warmup_steps, warm, cos).to(F32)

    return sched


def get_schedule(name: str, peak_lr: float, total_steps: int = 10000, **kw):
    if name == "constant":
        return constant(peak_lr)
    if name == "cosine":
        return cosine_with_warmup(peak_lr, total_steps, **kw)
    raise ValueError(f"unknown schedule {name!r}")
