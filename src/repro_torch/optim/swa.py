"""Stochastic Weight Averaging: a running mean of the parameters from
``start_step`` on (the paper stabilizes PSG with it, §4.1);
:func:`swa_params` gives the average to evaluate with.

The count stays a host integer (the JAX package's int32 leaf in a
checkpoint) and each update's weight is decided on the host
(:func:`swa_weight`); :func:`swa_average` applies it on the device, in
place, so a captured step takes the weight as a per-step input."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def swa_init(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {"avg": {k: p.detach().float().clone() for k, p in params.items()},
            "count": 0}


def swa_weight(count: int, step: int, start_step: int) -> Tuple[float, int]:
    """``(w, new count)`` of the update at ``step``: ``1 / (count + 1)`` in
    float32 from ``start_step`` on, else 0 with the count unchanged."""
    if step < start_step:
        return 0.0, count
    return float(np.float32(1) / np.float32(count + 1)), count + 1


@torch.no_grad()
def swa_average(state: Dict[str, Any], params: Dict[str, torch.Tensor],
                w) -> None:
    """``avg += w * (p - avg)`` in place, ``w`` a float or a 0-d tensor;
    the JAX package's update, which also runs at ``w = 0``."""
    for k, a in state["avg"].items():
        a += w * (params[k].float() - a)


def swa_update(state: Dict[str, Any], params: Dict[str, torch.Tensor],
               step: int, start_step: int) -> None:
    w, state["count"] = swa_weight(state["count"], step, start_step)
    swa_average(state, params, w)


def swa_params(state: Dict[str, Any], like: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """The average cast to each parameter's dtype, as new tensors (never the
    average's own storage)."""
    return {k: a.to(dtype=like[k].dtype, copy=True)
            for k, a in state["avg"].items()}
