"""Deterministic synthetic CIFAR-shaped data (no dataset download).

``GaussianImageTask``: class-conditional Gaussian images, 32x32x3, K
classes.  The class means come from numpy's ``RandomState`` exactly as in
the JAX package; labels and noise come from a ``torch.Generator`` keyed on
``(seed, step, shard)`` (``core/rng.py``) on the target device, so every
batch is a pure function of its key and a dropped step costs nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.core import rng


@dataclass(frozen=True)
class GaussianImageTask:
    num_classes: int = 10
    hw: int = 32
    snr: float = 1.0
    seed: int = 99

    def means(self) -> np.ndarray:
        r = np.random.RandomState(self.seed)
        return r.randn(self.num_classes, self.hw, self.hw, 3).astype(np.float32)


def make_image_batch(task: GaussianImageTask, seed: int, step: int, shard: int,
                     batch: int, device) -> Dict[str, torch.Tensor]:
    """``{"image": (batch, hw, hw, 3) fp32, "label": (batch,) int64}``."""
    g = rng.generator(rng.DATA, seed, step, shard, device=device)
    labels = torch.randint(0, task.num_classes, (batch,), generator=g,
                           device=device)
    noise = torch.randn((batch, task.hw, task.hw, 3), generator=g,
                        device=device)
    means = torch.from_numpy(task.means()).to(device)
    return {"image": task.snr * means[labels] + noise, "label": labels}
