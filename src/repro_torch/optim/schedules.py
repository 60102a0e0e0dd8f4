"""Learning-rate schedules.  The paper: lr 0.1 with x0.1 step decays at 50%
and 75% of 64k iterations; decay points scale with the total budget.

The rate is computed in float32 on the host, with the same operations as the
JAX package, so both packages take the same step size."""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.config import TrainConfig


def make_schedule(cfg: TrainConfig):
    base, total = np.float32(cfg.lr), cfg.total_steps

    def step_fn(step: int) -> float:
        s = np.float32(step)
        if cfg.schedule == "constant":
            lr = base
        elif cfg.schedule == "cosine":
            t = np.clip(s / np.float32(total), np.float32(0), np.float32(1))
            lr = np.float32(0.5) * base * (np.float32(1)
                                          + np.cos(np.float32(math.pi) * t))
        else:  # step decay (paper)
            lr = base
            for frac in cfg.decay_points:
                if s >= np.float32(frac * total):
                    lr = lr * np.float32(cfg.decay_factor)
        if cfg.warmup_steps:
            lr = lr * np.clip(s / np.float32(cfg.warmup_steps),
                              np.float32(0), np.float32(1))
        return float(np.float32(lr))

    return step_fn
