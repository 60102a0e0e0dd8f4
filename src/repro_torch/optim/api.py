"""The optimizer facade the train step uses."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.core.config import TrainConfig
from repro_torch.optim import schedules, sgd, signsgd


@dataclass(frozen=True)
class Optimizer:
    init: Callable          # params -> state
    apply: Callable         # (params, grads, state, step) -> None, in place
    name: str


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    sched = schedules.make_schedule(cfg)
    if cfg.optimizer == "sgdm":
        def apply(params, grads, state, step):
            sgd.sgd_apply(params, grads, state, sched(step),
                          momentum=cfg.momentum, weight_decay=cfg.weight_decay)
        return Optimizer(sgd.sgd_init, apply, "sgdm")
    if cfg.optimizer in ("signsgd", "psg"):
        # "psg" is signSGD without momentum: PSG emits the sign itself
        momentum = cfg.momentum if cfg.optimizer == "signsgd" else 0.0

        def apply(params, grads, state, step):
            signsgd.signsgd_apply(params, grads, state, sched(step),
                                  momentum=momentum,
                                  weight_decay=cfg.weight_decay)
        return Optimizer(signsgd.signsgd_init, apply, cfg.optimizer)
    if cfg.optimizer == "adamw":
        def apply(params, grads, state, step):
            sgd.adamw_apply(params, grads, state, sched(step),
                            weight_decay=cfg.weight_decay)
        return Optimizer(sgd.adamw_init, apply, "adamw")
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
