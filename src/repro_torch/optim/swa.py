"""Stochastic Weight Averaging: a running mean of the parameters from
``start_step`` on (the paper stabilizes PSG with it, §4.1);
:func:`swa_params` gives the average to evaluate with."""
from __future__ import annotations

from typing import Any, Dict

import torch


def swa_init(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {"avg": {k: p.detach().float().clone() for k, p in params.items()},
            "count": 0}


@torch.no_grad()
def swa_update(state: Dict[str, Any], params: Dict[str, torch.Tensor],
               step: int, start_step: int) -> None:
    if step < start_step:
        return
    state["count"] += 1
    w = 1.0 / state["count"]
    for k, a in state["avg"].items():
        a += w * (params[k].float() - a)


def swa_params(state: Dict[str, Any], like: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """The average cast to each parameter's dtype, as new tensors (never the
    average's own storage)."""
    return {k: a.to(dtype=like[k].dtype, copy=True)
            for k, a in state["avg"].items()}
