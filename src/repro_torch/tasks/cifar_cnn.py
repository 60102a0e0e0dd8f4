"""``cifar_cnn`` task: the paper's CIFAR ResNets (ResNet branch only; a
model named ``"mobilenetv2"`` is not ported yet)."""
from __future__ import annotations

from repro_torch.core.config import Experiment
from repro_torch.core.cost import cnn_cost
from repro_torch.core.slu import resnet_uniforms
from repro_torch.models import resnet as R
from repro_torch.tasks import Task, eval_logits, register


def _init(exp: Experiment, seed: int = 0, device=None) -> R.ResNet:
    m = exp.model
    if m.name == "mobilenetv2":
        raise NotImplementedError("MobileNetV2 is not ported yet")
    return R.ResNet(m.num_layers, num_classes=m.vocab_size, e2=exp.e2,
                    width=m.d_model, seed=seed).to(device)


def _make_loss(exp: Experiment):
    def loss(model, batch, key, keep=None, slu_u=None):
        return R.resnet_loss(model, batch, key, keep=keep, slu_u=slu_u)
    return loss


def _slu_uniforms(exp: Experiment, key):
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
