"""Train step: loss and gradients under PSG, sign vote, optimizer, SWA.

``make_train_step(exp)`` returns ``train_step(state, batch, keep=None) ->
(state, metrics)``, the counterpart of the JAX package's
``training/train_step.py``:

* the loss runs under ``psg.enable(cfg, probe)``; the probe's gradient is
  the step's MAC-weighted ``psg_fallback_ratio`` (``core/psg.py``);
* the task's SLU draws are keyed on ``fold_in(PRNGKey(seed), step)``, the
  JAX package's step key (``core/rng.py``);
* with PSG on, every gradient is re-signed (``majority_vote_tree``):
  norms, embeddings, classifier and gate included;
* the optimizer updates the parameters in place, then SWA averages them;
* the BatchNorm statistics (ResNet) are buffers of the model, updated by
  the forward; the optimizer never sees them.  The LM holds none.

Only ``microbatches == 1`` is implemented.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core import psg as psgmod
from repro_torch.core import rng
from repro_torch.core.config import Experiment
from repro_torch.core.device import resolve_device
from repro_torch.optim import make_optimizer, majority_vote_tree
from repro_torch.optim.swa import swa_init, swa_update
from repro_torch.tasks import get_task


@dataclass
class TrainState:
    model: nn.Module              # parameters + BatchNorm buffers
    opt: Dict[str, torch.Tensor]
    swa: Optional[Dict[str, Any]]
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def init_train_state(exp: Experiment, seed: int = 0,
                     device=None) -> TrainState:
    """Model from ``seed`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return train_state_for(exp, get_task(exp.task).init(exp, seed, dev))


def train_state_for(exp: Experiment, model: nn.Module) -> TrainState:
    """A fresh optimizer (and SWA) state around ``model``, at step 0."""
    params = dict(model.named_parameters())
    swa = swa_init(params) if (exp.e2.psg.enabled and exp.e2.psg.swa) else None
    return TrainState(model, make_optimizer(exp.train).init(params), swa, 0)


def make_train_step(exp: Experiment):
    e2, tc = exp.e2, exp.train
    if tc.microbatches != 1:
        raise NotImplementedError("microbatch accumulation is not ported yet")
    task_loss = get_task(exp.task).make_loss(exp)
    opt = make_optimizer(tc)
    psg_cfg = e2.psg if e2.psg.enabled else None
    swa_start = int(tc.total_steps * e2.psg.swa_start_frac)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   keep: Optional[Sequence[bool]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        names, params = zip(*state.model.named_parameters())
        device = params[0].device
        probe = psgmod.zero_probe(device) if psg_cfg is not None else None
        with psgmod.enable(psg_cfg, probe=probe):
            key = rng.fold_in(rng.PRNGKey(tc.seed), state.step)
            loss, metrics = task_loss(state.model, batch, key, keep)
        inputs = list(params) + ([probe] if probe is not None else [])
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        probe_g = grads.pop() if probe is not None else None
        grads = dict(zip(names, grads))
        if psg_cfg is not None:
            grads = majority_vote_tree(grads)
        gn = torch.zeros((), device=device)
        if tc.grad_clip > 0 and psg_cfg is None:
            gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
            scale = torch.clamp_max(tc.grad_clip / (gn + 1e-9), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
        param_d = dict(zip(names, params))
        opt.apply(param_d, grads, state.opt, state.step)
        if state.swa is not None:
            swa_update(state.swa, param_d, state.step, swa_start)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        metrics["grad_norm"] = gn
        if probe_g is not None:
            metrics["psg_fallback_ratio"] = psgmod.probe_fallback_ratio(probe_g)
        state.step += 1
        return state, metrics

    return train_step
