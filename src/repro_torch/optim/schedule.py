"""Learning-rate schedule (a pure function of the step counter), computed
on the host in float32 as the JAX package computes it on the device."""
from __future__ import annotations

import numpy as np


def warmup_cosine(step: int, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> float:
    f32 = np.float32
    s = f32(step)
    if s < f32(warmup_steps):
        return float(f32(peak_lr) * s / f32(max(warmup_steps, 1)))
    t = (s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
    t = np.clip(t, f32(0.0), f32(1.0))
    cos = f32(peak_lr) * (f32(final_frac) + f32(1 - final_frac) * f32(0.5)
                          * (f32(1) + np.cos(f32(np.pi) * t)))
    return float(f32(cos))
