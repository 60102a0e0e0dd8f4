"""SignSGD [Bernstein et al. 2018], the update PSG plugs into:
``w <- w - lr * (sign(m) + wd * w)`` with ``m = g`` when ``momentum`` is 0
(the ``psg`` optimizer) and a Signum buffer otherwise.  Updates in place,
every state tensor keeping its storage (a captured step replays them); the
state is ``{"momentum": {name: tensor}}``, the JAX package's layout.  The
learning rate may be a float or a 0-d tensor on the device."""
from __future__ import annotations

from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


def signsgd_init(params: Tensors) -> Dict[str, Tensors]:
    return {"momentum": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def signsgd_apply(params: Tensors, grads: Tensors, state: Dict[str, Tensors],
                  lr, *, momentum: float = 0.0,
                  weight_decay: float = 0.0) -> None:
    mom = state["momentum"]
    for k, p in params.items():
        g = grads[k].float()
        m = momentum * mom[k] + (1 - momentum) * g if momentum > 0 else g
        p.copy_(p - lr * (torch.sign(m) + weight_decay * p))
        mom[k].copy_(m)
