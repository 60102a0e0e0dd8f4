"""``cifar_cnn`` task: the paper's own backbones on CIFAR-shaped batches.

``num_layers`` is the ResNet depth (6n+2), ``d_model`` the stage-0 width,
``vocab_size`` the class count (``configs/paper_cnns.cnn_model``); a model
named ``"mobilenetv2"`` selects the MobileNetV2 backbone instead, which has
no SLU gate: its steps draw no SLU uniforms, and ``e2.slu`` is ignored, as
in the JAX package.
"""
from __future__ import annotations

import numpy as np
from torch import nn

from repro_torch.core.config import Experiment
from repro_torch.core.cost import cnn_cost
from repro_torch.core.slu import resnet_uniforms
from repro_torch.models import resnet as R
from repro_torch.tasks import Task, eval_logits, register


def _is_mobilenet(exp: Experiment) -> bool:
    return exp.model.name == "mobilenetv2"


def _init(exp: Experiment, seed: int = 0, device=None) -> nn.Module:
    m = exp.model
    if _is_mobilenet(exp):
        return R.MobileNetV2(num_classes=m.vocab_size, seed=seed).to(device)
    return R.ResNet(m.num_layers, num_classes=m.vocab_size, e2=exp.e2,
                    width=m.d_model, seed=seed).to(device)


def _make_loss(exp: Experiment):
    return R.mobilenetv2_loss if _is_mobilenet(exp) else R.resnet_loss


def _slu_uniforms(exp: Experiment, key):
    """One uniform per gated block; MobileNetV2 has none."""
    if _is_mobilenet(exp):
        return np.zeros((0,), np.float32)
    return resnet_uniforms(key, 3 * R.resnet_depth_to_n(exp.model.num_layers))


def _make_predict(exp: Experiment):
    def predict(model, batch):
        return eval_logits(model, batch["image"])
    return predict


CIFAR_CNN_TASK = register(Task(name="cifar_cnn", init=_init,
                               make_loss=_make_loss,
                               make_predict=_make_predict,
                               slu_uniforms=_slu_uniforms,
                               cost=lambda exp: cnn_cost(exp.model)))
