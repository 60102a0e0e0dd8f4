"""The optimizer facade the train step uses.

A step's update splits into what the host decides and what the device
does, so that a captured CUDA graph can replay the device half:
``scalars(state, step)`` gives the step's float32 scalars (the learning
rate, and AdamW's bias corrections from its count), ``update(params,
grads, state, scal)`` applies them on the device in place (``scal`` the
same scalars as 0-d tensors, in that order), and ``advance(state)`` moves
the host counters on.  ``apply(params, grads, state, step)`` is the three
in a row."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

from repro_torch.core.config import TrainConfig
from repro_torch.optim import schedules, sgd, signsgd


@dataclass(frozen=True)
class Optimizer:
    init: Callable          # params -> state
    scalars: Callable       # (state, step) -> [lr, ...] float32 values
    update: Callable        # (params, grads, state, scal) -> None, in place
    advance: Callable       # state -> None, the host counters
    name: str

    def apply(self, params, grads, state, step: int) -> None:
        self.update(params, grads, state, self.scalars(state, step))
        self.advance(state)


def _no_advance(state) -> None:
    return None


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    sched = schedules.make_schedule(cfg)

    def lr_only(state, step: int) -> List[float]:
        return [sched(step)]

    if cfg.optimizer == "sgdm":
        def update(params, grads, state, scal):
            sgd.sgd_apply(params, grads, state, scal[0],
                          momentum=cfg.momentum, weight_decay=cfg.weight_decay)
        return Optimizer(sgd.sgd_init, lr_only, update, _no_advance, "sgdm")
    if cfg.optimizer in ("signsgd", "psg"):
        # "psg" is signSGD without momentum: PSG emits the sign itself
        momentum = cfg.momentum if cfg.optimizer == "signsgd" else 0.0

        def update(params, grads, state, scal):
            signsgd.signsgd_apply(params, grads, state, scal[0],
                                  momentum=momentum,
                                  weight_decay=cfg.weight_decay)
        return Optimizer(signsgd.signsgd_init, lr_only, update, _no_advance,
                         cfg.optimizer)
    if cfg.optimizer == "adamw":
        def scalars(state, step: int) -> List[float]:
            return [sched(step), *sgd.adamw_corrections(state["count"] + 1)]

        def update(params, grads, state, scal):
            sgd.adamw_update(params, grads, state, *scal,
                             weight_decay=cfg.weight_decay)

        def advance(state) -> None:
            state["count"] += 1
        return Optimizer(sgd.adamw_init, scalars, update, advance, "adamw")
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
