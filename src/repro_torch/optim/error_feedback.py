"""Error feedback for sign compression (EF-SignSGD, Karimireddy et al. '19).

Plain SignSGD/PSG discards the gradient's magnitude; error feedback keeps
the discarded residual locally and adds it back the next step, with the
1-bit payload unchanged, so it composes with the majority vote (the
residual never crosses the wire).  Nothing on the training path calls it,
as in the JAX package."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def ef_init(params: Tensors) -> Dict[str, Tensors]:
    return {"residual": {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()}}


@torch.no_grad()
def ef_compress(grads: Tensors, state: Dict[str, Tensors], scale: float = 1.0
                ) -> Tuple[Tensors, Dict[str, Tensors]]:
    """``(sign payload, new state)``: with ``c = g + e`` the payload is
    ``sign(c)`` and the residual ``c - scale * mean|c| * sign(c)`` (the
    scaled-sign variant, which keeps ``c``'s mean magnitude)."""
    payload, residual = {}, {}
    for k, g in grads.items():
        corr = g.float() + state["residual"][k]
        payload[k] = torch.sign(corr)
        residual[k] = corr - scale * torch.mean(torch.abs(corr)) * payload[k]
    return payload, {"residual": residual}
