"""SGD with momentum and coupled weight decay (the He et al. baseline).
Updates in place."""
from __future__ import annotations

from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


def sgd_init(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p) for k, p in params.items()}


@torch.no_grad()
def sgd_apply(params: Tensors, grads: Tensors, state: Tensors, lr: float, *,
              momentum: float = 0.9, weight_decay: float = 1e-4) -> None:
    for k, p in params.items():
        g = grads[k].float() + weight_decay * p
        m = momentum * state[k] + g
        p.copy_(p - lr * m)
        state[k] = m
