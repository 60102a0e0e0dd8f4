"""SGD with momentum and coupled weight decay (the He et al. baseline), and
AdamW.  Updates in place: every state tensor keeps its storage, so a
captured CUDA graph that replays an update reads and writes the same
tensors each time.  The learning rate may be a Python float or a 0-d tensor
on the parameters' device (a per-step input of a captured step).

The states keep the JAX package's layout, so a checkpoint holds the same
leaves in either package: ``{"momentum": {name: tensor}}`` for SGD, and
``{"mu": ..., "nu": ..., "count": int}`` for AdamW."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
ADAM_B1, ADAM_B2 = 0.9, 0.95


def sgd_init(params: Tensors) -> Dict[str, Tensors]:
    return {"momentum": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def sgd_apply(params: Tensors, grads: Tensors, state: Dict[str, Tensors],
              lr, *, momentum: float = 0.9,
              weight_decay: float = 1e-4) -> None:
    mom = state["momentum"]
    for k, p in params.items():
        g = grads[k].float() + weight_decay * p
        m = momentum * mom[k] + g
        p.copy_(p - lr * m)
        mom[k].copy_(m)


def adamw_init(params: Tensors) -> Dict[str, Any]:
    return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            "count": 0}


def adamw_corrections(count: int, b1: float = ADAM_B1, b2: float = ADAM_B2
                      ) -> Tuple[float, float]:
    """The bias corrections of AdamW's update number ``count`` (1-based):
    float32 ``1 - b^count``, as the JAX package computes them."""
    return tuple(float(np.float32(1) - np.float32(b) ** np.float32(count))
                 for b in (b1, b2))


@torch.no_grad()
def adamw_apply(params: Tensors, grads: Tensors, state: Dict[str, Any],
                lr, *, b1: float = ADAM_B1, b2: float = ADAM_B2,
                eps: float = 1e-8, weight_decay: float = 0.1) -> None:
    """Adam with decoupled weight decay; the bias corrections are float32
    powers of the int32 step count, as in the JAX package."""
    c = state["count"] + 1
    adamw_update(params, grads, state, lr, *adamw_corrections(c, b1, b2),
                 b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    state["count"] = c


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: Dict[str, Any],
                 lr, bc1, bc2, *, b1: float = ADAM_B1, b2: float = ADAM_B2,
                 eps: float = 1e-8, weight_decay: float = 0.1) -> None:
    """The update alone, with the bias corrections given (floats, or 0-d
    tensors on the device) and the count left as it is."""
    mu, nu = state["mu"], state["nu"]
    for k, p in params.items():
        g = grads[k].float()
        mu[k].copy_(b1 * mu[k] + (1 - b1) * g)
        nu[k].copy_(b2 * nu[k] + (1 - b2) * g * g)
        step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) \
            + weight_decay * p
        p.copy_(p - lr * step)
