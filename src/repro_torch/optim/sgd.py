"""SGD with momentum and coupled weight decay (the He et al. baseline), and
AdamW.  Updates in place.

The states keep the JAX package's layout, so a checkpoint holds the same
leaves in either package: ``{"momentum": {name: tensor}}`` for SGD, and
``{"mu": ..., "nu": ..., "count": int}`` for AdamW."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def sgd_init(params: Tensors) -> Dict[str, Tensors]:
    return {"momentum": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def sgd_apply(params: Tensors, grads: Tensors, state: Dict[str, Tensors],
              lr: float, *, momentum: float = 0.9,
              weight_decay: float = 1e-4) -> None:
    mom = state["momentum"]
    for k, p in params.items():
        g = grads[k].float() + weight_decay * p
        m = momentum * mom[k] + g
        p.copy_(p - lr * m)
        mom[k] = m


def adamw_init(params: Tensors) -> Dict[str, Any]:
    return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            "count": 0}


@torch.no_grad()
def adamw_apply(params: Tensors, grads: Tensors, state: Dict[str, Any],
                lr: float, *, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8, weight_decay: float = 0.1) -> None:
    """Adam with decoupled weight decay; the bias corrections are float32
    powers of the int32 step count, as in the JAX package."""
    c = state["count"] + 1
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(c))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(c))
    mu, nu = state["mu"], state["nu"]
    for k, p in params.items():
        g = grads[k].float()
        mu[k] = b1 * mu[k] + (1 - b1) * g
        nu[k] = b2 * nu[k] + (1 - b2) * g * g
        step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) \
            + weight_decay * p
        p.copy_(p - lr * step)
    state["count"] = c
