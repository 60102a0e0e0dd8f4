"""SignSGD [Bernstein et al. 2018], the update PSG plugs into:
``w <- w - lr * (sign(m) + wd * w)`` with ``m = g`` when ``momentum`` is 0
(the ``psg`` optimizer) and a Signum buffer otherwise.  Updates in place."""
from __future__ import annotations

from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


def signsgd_init(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p) for k, p in params.items()}


@torch.no_grad()
def signsgd_apply(params: Tensors, grads: Tensors, state: Tensors, lr: float,
                  *, momentum: float = 0.0, weight_decay: float = 0.0) -> None:
    for k, p in params.items():
        g = grads[k].float()
        m = momentum * state[k] + (1 - momentum) * g if momentum > 0 else g
        p.copy_(p - lr * (torch.sign(m) + weight_decay * p))
        state[k] = m
