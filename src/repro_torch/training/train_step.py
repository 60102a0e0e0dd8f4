"""Train step: loss and gradients under PSG, microbatch accumulation, sign
vote, optimizer, SWA; and the weights and BatchNorm state to evaluate with.

``make_train_step(exp)`` returns ``train_step(state, batch, keep=None) ->
(state, metrics)`` (a :class:`TrainStep`, whose host and device halves the
chunked loop drives apart), the counterpart of the JAX package's
``training/train_step.py``:

* the loss runs under ``psg.enable(cfg, probe)``; the probe's gradient is
  the step's MAC-weighted ``psg_fallback_ratio`` (``core/psg.py``);
* the task's SLU draws are keyed on ``fold_in(PRNGKey(seed), step)``, the
  JAX package's step key (``core/rng.py``);
* with ``microbatches = m > 1`` the batch splits as ``(m, B/m, ...)`` and
  microbatch ``i`` runs with the key ``fold_in(step_key, i)``, its
  backward before the next forward; the gradients and the probe gradients
  sum, the BatchNorm statistics thread through the microbatches in order,
  the gradient is divided by ``m`` (with PSG, the re-sign below makes it
  the vote over microbatches), and the loss and metrics are the mean over
  microbatches;
* with PSG on, every gradient is re-signed (``majority_vote_tree``):
  norms, embeddings, classifier and gate included;
* under a mesh (``dp``, a ``distributed/fsdp.DataParallel``, with the
  trainer inside ``sharding.activation_sharding``) each rank runs its rows
  of the global batch; the loss, the metrics and every coupling of rows
  are the global batch's (``distributed/sharding``'s collectives), each
  rank differentiates its share of the loss (the global loss over the
  world size) with respect to its parameters, shards of the sharded ones:
  their gradients come out of the backward summed over the data axis
  (each sub-block's as its backward ends, ``distributed/fsdp.py``; a
  microbatch's before the next), the replicated leaves' are summed after
  it (a PSG weight's sign, global and equal on every rank already, comes
  out of the sum and the re-sign unchanged), the clip's norm is the
  global gradient's, and the optimizer and SWA update each rank's shards
  in place, with no gather after;
* the optimizer updates the parameters in place, then SWA averages them;
  the learning rate, AdamW's bias corrections and SWA's weight are
  float32 scalars computed on the host and handed to the device as a
  tensor, the same in every mode;
* the BatchNorm statistics (the CNNs) are buffers of the model, updated by
  the forward; the optimizer never sees them.  The LM holds none.

:func:`eval_params` and :func:`recalibrate_model_state` are the JAX
package's evaluation helpers on the port's modules.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import psg as psgmod
from repro_torch.core import rng
from repro_torch.core.config import Experiment
from repro_torch.core.device import resolve_device
from repro_torch.optim import make_optimizer, majority_vote_tree
from repro_torch.optim.swa import (swa_average, swa_init, swa_params,
                                   swa_weight)
from repro_torch.tasks import get_task


@dataclass
class TrainState:
    model: nn.Module              # parameters + BatchNorm buffers
    opt: Dict[str, torch.Tensor]
    swa: Optional[Dict[str, Any]]
    step: int = 0
    # the mesh the state is placed on (ft/elastic.py: this rank's shards
    # of the FSDP leaves' parameters, moments and SWA average), None for
    # the full state
    mesh: Optional[Any] = None

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


def split_microbatches(batch: Dict[str, torch.Tensor], m: int
                       ) -> Sequence[Dict[str, torch.Tensor]]:
    """``batch`` as ``m`` microbatches of ``B / m`` rows, in order.  Under
    a mesh ``batch`` is a rank's rows in the order of
    ``distributed/sharding.rank_rows``, whose microbatch ``i`` is then the
    rank's part of the global batch's microbatch ``i``."""
    if m == 1:
        return [batch]
    rows = {v.shape[0] for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % m:
        raise ValueError(f"microbatches={m} does not divide the batch "
                         f"(rows {sorted(rows)})")
    parts = {k: v.chunk(m) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(m)]


class TrainStep:
    """One training step, split into what the host decides and what the
    device does, so that a CUDA graph can hold the device half:

    * ``host_inputs(state)`` -> ``(u, scal)``: the step's SLU uniforms, fp32
      ``(m, n)`` (one row per microbatch, drawn with the keys the model
      would draw with; ``None`` without SLU or without a gated block), and
      its float32 scalars ``[swa weight, lr, ...]`` (the optimizer's,
      ``optim/api.py``), from ``state.step`` and the host counters;
    * ``device_step(state, batch, u, scal)`` -> ``(metrics, slu_executed)``:
      the loss, gradients, optimizer update and SWA average on the
      device, in place; ``u`` and ``scal`` host arrays or tensors, the
      0-d metrics and the stacked SLU flags device tensors; it reads no
      value back when ``u`` and ``scal`` are CUDA tensors inside a capture;
    * ``advance(state)``: the host counters (``state.step``, AdamW's and
      SWA's counts) after the step.

    ``step(state, batch, keep=None) -> (metrics, slu_executed)`` runs the
    three in a row, and so does calling the object, ``train_step(state,
    batch, keep=None) -> (state, metrics)``; ``keep`` (tests only) injects
    the ResNet's SLU decisions, the same for every microbatch.
    """

    def __init__(self, exp: Experiment):
        e2, tc = exp.e2, exp.train
        self.exp = exp
        self.m = max(tc.microbatches, 1)
        self.task = get_task(exp.task)
        self.task_loss = self.task.make_loss(exp)
        self.opt = make_optimizer(tc)
        self.psg_cfg = e2.psg if e2.psg.enabled else None
        self.swa_start = int(tc.total_steps * e2.psg.swa_start_frac)
        self.slu = e2.slu.enabled and self.task.slu_uniforms is not None
        self.dp = None      # a DataParallel under a mesh of >1 ranks

    # -- host -------------------------------------------------------------

    def step_key(self, step: int) -> rng.Key:
        return rng.fold_in(rng.PRNGKey(self.exp.train.seed), step)

    def host_inputs(self, state: TrainState
                    ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        key = self.step_key(state.step)
        u = None
        if self.slu:
            keys = [key] if self.m == 1 else \
                [rng.fold_in(key, i) for i in range(self.m)]
            u = np.stack([self.task.slu_uniforms(self.exp, k) for k in keys])
            if not u.size:      # no gated block (MobileNetV2): no draws
                u = None
        w = 0.0
        if state.swa is not None:
            w, _ = swa_weight(state.swa["count"], state.step, self.swa_start)
        scal = np.array([w, *self.opt.scalars(state.opt, state.step)],
                        np.float32)
        return u, scal

    def advance(self, state: TrainState) -> None:
        if state.swa is not None:
            _, state.swa["count"] = swa_weight(state.swa["count"], state.step,
                                               self.swa_start)
        self.opt.advance(state.opt)
        state.step += 1

    # -- device -----------------------------------------------------------

    def _grad_step(self, model, names, params, batch, key, keep, u):
        """Loss, metrics, gradients, probe gradient and SLU flags of one
        (micro)batch."""
        probe = psgmod.zero_probe(params[0].device) \
            if self.psg_cfg is not None else None
        seen = []
        hook = model.register_forward_hook(
            lambda mod, args, out: seen.append(out[1]["slu_executed"]))
        try:
            with psgmod.enable(self.psg_cfg, probe=probe):
                loss, metrics = self.task_loss(model, batch, key, keep,
                                               slu_u=u)
        finally:
            hook.remove()
        inputs = list(params) + ([probe] if probe is not None else [])
        share = loss if self.dp is None else loss / self.dp.world
        grads = torch.autograd.grad(share, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        probe_g = grads.pop() if probe is not None else None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics, dict(zip(names, grads)), probe_g,
                seen[-1].reshape(-1))

    def device_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                    u, scal, keep: Optional[Sequence[bool]] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        m, tc = self.m, self.exp.train
        names, params = zip(*state.model.named_parameters())
        device = params[0].device
        key = self.step_key(state.step)
        row = (lambda i: None) if u is None else (lambda i: u[i])
        if m == 1:
            loss, metrics, grads, probe_g, flags = self._grad_step(
                state.model, names, params, batch, key, keep, row(0))
        else:
            losses, mets, flag_l, grads, probe_g = [], [], [], None, None
            for i, mb in enumerate(split_microbatches(batch, m)):
                l, mt, g, pg, fl = self._grad_step(
                    state.model, names, params, mb, rng.fold_in(key, i),
                    keep, row(i))
                grads = g if grads is None else \
                    {k: grads[k] + g[k] for k in names}
                if pg is not None:
                    probe_g = pg if probe_g is None else probe_g + pg
                losses.append(l)
                mets.append(mt)
                flag_l.append(fl)
            grads = {k: g / m for k, g in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([mt[k] for mt in mets]).mean()
                       for k in mets[0]}
            flags = torch.cat(flag_l)
        if self.dp is not None:
            grads = self.dp.reduce_grads(grads)
        if self.psg_cfg is not None:
            grads = majority_vote_tree(grads)
        gn = torch.zeros((), device=device)
        if tc.grad_clip > 0 and self.psg_cfg is None:
            gn = self.dp.grad_norm(grads) if self.dp is not None else \
                torch.sqrt(sum(torch.sum(g.float() ** 2)
                               for g in grads.values()))
            scale = torch.clamp_max(tc.grad_clip / (gn + 1e-9), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
        param_d = dict(zip(names, params))
        self.opt.update(param_d, grads, state.opt, list(scal[1:]))
        if state.swa is not None:
            swa_average(state.swa, param_d, scal[0])
        metrics["total_loss"] = loss
        metrics["grad_norm"] = gn
        if probe_g is not None:
            metrics["psg_fallback_ratio"] = \
                psgmod.probe_fallback_ratio(probe_g)
        return metrics, flags

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor],
             keep: Optional[Sequence[bool]] = None
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One whole step: ``(metrics, slu_executed)``."""
        u, scal = self.host_inputs(state)
        device = next(state.model.parameters()).device
        out = self.device_step(state, batch, u,
                               torch.from_numpy(scal).to(device), keep)
        self.advance(state)
        return out

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 keep: Optional[Sequence[bool]] = None
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        return state, self.step(state, batch, keep)[0]


def make_train_step(exp: Experiment) -> TrainStep:
    """``train_step(state, batch, keep=None) -> (state, metrics)``
    (:class:`TrainStep`)."""
    return TrainStep(exp)


def eval_params(state: TrainState, exp: Experiment) -> nn.Module:
    """The model to evaluate with: with SWA on, a copy of the model holding
    the SWA average cast to each parameter's dtype (sharing no storage with
    the live parameters or the average; the BatchNorm buffers are copies of
    the live ones); otherwise the live model itself.

    As in the JAX package, the BatchNorm statistics tracked the raw
    trajectory, not the average: recalibrate them on the copy
    (:func:`recalibrate_model_state`) to evaluate SWA weights by the book.
    """
    if state.swa is None:
        return state.model
    model = copy.deepcopy(state.model)
    avg = swa_params(state.swa, dict(model.named_parameters()))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(avg[name])
    return model


@torch.no_grad()
def recalibrate_model_state(exp: Experiment, model: nn.Module,
                            batches: Iterable[Dict[str, torch.Tensor]],
                            key: Optional[rng.Key] = None
                            ) -> Dict[str, torch.Tensor]:
    """Re-estimate ``model``'s BatchNorm statistics in place by train-mode
    forwards over ``batches`` (SWA's BN recalibration) and return them.

    Batch ``i`` runs with the key ``fold_in(key, i)`` (``key`` defaults to
    ``PRNGKey(seed)``), so its SLU draws are the JAX package's; outside
    ``psg.enable``, so the convs are the plain products, as in the
    reference.  A no-op for the LM, which holds no buffers.  The model is
    left in the mode it was found in.
    """
    if not any(True for _ in model.buffers()):
        return {}
    loss = get_task(exp.task).make_loss(exp)
    key = rng.PRNGKey(exp.train.seed) if key is None else key
    was = model.training
    model.train()
    try:
        for i, batch in enumerate(batches):
            loss(model, batch, rng.fold_in(key, i))
    finally:
        model.train(was)
    return {k: b.detach().clone() for k, b in model.named_buffers()}
