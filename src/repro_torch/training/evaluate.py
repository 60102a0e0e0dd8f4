"""Held-out top-1 accuracy: the counterpart of the JAX package's evaluation
(``benchmarks/bench_cnn.py`` for the CIFAR ResNets, ``eval_accuracy`` in
``benchmarks/common.py`` for the LM), on the same protocol:

* images: the training task's Gaussian classes (snr 2.0), data seed 99,
  batches 0-3 of 32 images;
* tokens: the training task's Markov chain, data seed 999, batches 0-3 of
  16 x 32 tokens, next-token accuracy over the labels >= 0.

The weights are :func:`~repro_torch.training.train_step.eval_params` (the
SWA average when SWA is on) with the trainer's BatchNorm statistics; an
optional recalibration of those statistics runs over training batches,
never held-out ones.  Prediction is the task's ``make_predict``: eval mode,
no SLU, no PSG.
"""
from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional

import torch
from torch import nn

from repro_torch.core.config import Experiment
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import (GaussianImageTask, MarkovLMTask,
                                        make_image_batch, make_lm_batch)
from repro_torch.tasks import get_task
from repro_torch.training.train_step import (eval_params,
                                             recalibrate_model_state)

IMAGE_SNR = 2.0
HELDOUT_BATCHES = 4
IMAGE_SEED, IMAGE_BATCH = 99, 32
TOKEN_SEED, TOKEN_BATCH, TOKEN_SEQ = 999, 16, 32


def data_task(exp: Experiment):
    """The synthetic task an experiment trains on (and is evaluated on)."""
    if exp.task == "cifar_cnn":
        return GaussianImageTask(num_classes=exp.model.vocab_size,
                                 snr=IMAGE_SNR)
    return MarkovLMTask(vocab=exp.model.vocab_size)


def heldout_batch(exp: Experiment, i: int, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Held-out batch ``i`` of the protocol, on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    if exp.task == "cifar_cnn":
        return make_image_batch(data_task(exp), IMAGE_SEED, i, 0, IMAGE_BATCH,
                                dev)
    return make_lm_batch(data_task(exp), TOKEN_SEED, i, 0, TOKEN_BATCH,
                         TOKEN_SEQ, dev)


def accuracy(exp: Experiment, model: nn.Module, device=None,
             n_batches: int = HELDOUT_BATCHES) -> float:
    """Top-1 accuracy of ``model`` over the held-out batches."""
    predict = get_task(exp.task).make_predict(exp)
    correct = total = 0
    for i in range(n_batches):
        b = heldout_batch(exp, i, device)
        labels = b["label"] if exp.task == "cifar_cnn" else b["labels"]
        pred = predict(model, b).argmax(-1)
        mask = labels >= 0
        correct += int((pred[mask] == labels[mask]).sum())
        total += int(mask.sum())
    return correct / max(total, 1)


def evaluate(trainer, recalibrate_batches: Optional[
        Iterable[Dict[str, torch.Tensor]]] = None) -> float:
    """Held-out accuracy of ``trainer``'s evaluation weights with its
    BatchNorm statistics, or with statistics recalibrated over
    ``recalibrate_batches`` (training batches) on a copy of the model."""
    model = eval_params(trainer.state, trainer.exp)
    if recalibrate_batches is not None:
        if model is trainer.state.model:
            model = copy.deepcopy(model)
        recalibrate_model_state(trainer.exp, model, recalibrate_batches)
    return accuracy(trainer.exp, model, trainer.device)
