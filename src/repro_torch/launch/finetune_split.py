"""Paper §4.5: adapting a pre-trained model (the JAX package's
``examples/finetune_split.py``).

    python -m repro_torch.launch.finetune_split [--device cpu]

Pre-train the 4-layer d-64 LM on one Markov task (A, seed 1234), then
fine-tune on a second (B, seed 5678) in the two energy-efficient ways the
paper compares:

1. the last layer alone, with standard training: sgdm on the LM head, every
   other gradient zeroed (and still passed through the optimizer, so its
   weight decay moves the frozen body, as in the reference);
2. every layer with E2-Train: SMD, SLU (alpha 1e-3, fresh gates from seed 2)
   and PSG (no SWA), the ``psg`` optimizer at lr 0.03, from the pre-trained
   body.

The paper finds (2) better on both loss and energy; the last line says
whether this run reproduces that.  Option 1 costs one energy unit a step;
option 2 its executed steps times the run's measured PSG factor (the
assumed one where none was measured) times the executed share of the
SLU-gated layers, from the run's ``energy_report``.  Each stage is a
function of its step count (80 / 60 / 240 here), so tests can run it
short.  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.convert import jax_path
from repro_torch.core.config import (E2TrainConfig, Experiment, ModelConfig,
                                     PSGConfig, SLUConfig, SMDConfig,
                                     TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import MarkovLMTask, make_lm_batch
from repro_torch.launch.train import _fp32_is_fp32
from repro_torch.models.transformer import TransformerLM, lm_loss
from repro_torch.optim import make_optimizer
from repro_torch.training.train_step import init_train_state, \
    train_state_for
from repro_torch.training.trainer import Trainer

MODEL = ModelConfig(name="ft", family="dense", num_layers=4, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                    dtype="float32")
TASK_A = MarkovLMTask(vocab=64, seed=1234)
TASK_B = MarkovLMTask(vocab=64, seed=5678)     # the "second half"
BATCH, SEQ = 16, 32
PRETRAIN_STEPS, HEAD_STEPS, E2_STEPS = 80, 60, 240
E2 = E2TrainConfig(smd=SMDConfig(True), slu=SLUConfig(True, alpha=1e-3),
                   psg=PSGConfig(True, swa=False))


def pretrain_experiment() -> Experiment:
    return Experiment(model=MODEL, train=TrainConfig(
        global_batch=BATCH, seq_len=SEQ, lr=0.1, total_steps=PRETRAIN_STEPS,
        schedule="constant"))


def e2_experiment() -> Experiment:
    exp = pretrain_experiment()
    return exp.replace(e2=E2, train=dataclasses.replace(
        exp.train, optimizer="psg", lr=0.03, total_steps=E2_STEPS))


def batches(task: MarkovLMTask, seed: int, dev: torch.device):
    return lambda step, shard: make_lm_batch(task, seed, step, shard, BATCH,
                                             SEQ, dev)


@torch.no_grad()
def eval_loss(model: nn.Module, task: MarkovLMTask, n: int = 4) -> float:
    """Mean loss over ``n`` held-out batches (data seed 777) of the model's
    weights with E2-Train off: the reference's ``lm_loss(params, batch,
    MODEL)`` ignores the SLU gates a fine-tuned model carries."""
    dev = next(model.parameters()).device
    plain = TransformerLM(MODEL, device=dev)
    plain.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith("slu_gate")})
    tot = 0.0
    for i in range(n):
        loss, _ = lm_loss(plain, make_lm_batch(task, 777, i, 0, BATCH, SEQ,
                                               dev), remat="none")
        tot += float(loss)
    return tot / n


def pretrain(steps: int = PRETRAIN_STEPS, device=None,
             init: Optional[nn.Module] = None
             ) -> Tuple[Trainer, List[Dict[str, float]]]:
    """sgdm at lr 0.1 on task A (data seed 0) from seed 0, or from
    ``init`` (a model on ``device``)."""
    dev = resolve_device(device)
    exp = pretrain_experiment()
    state = init_train_state(exp, seed=0, device=dev) if init is None \
        else train_state_for(exp, init)
    trainer = Trainer(exp, state, batches(TASK_A, 0, dev), device=dev)
    return trainer, trainer.run(steps)


def head_grads(model: nn.Module, loss: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """The gradients of ``loss``, zero for every parameter but the LM head
    (the reference's ``k == "head"``)."""
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return {n: g if jax_path(n)[0][0] == "head" else torch.zeros_like(g)
            for n, g in zip(params, grads)}


def head_only(base: nn.Module, steps: int = HEAD_STEPS
              ) -> Tuple[nn.Module, List[float]]:
    """Option 1: a copy of ``base`` trained ``steps`` steps of sgdm on task
    B (data seed 1) with only the head's gradient; every parameter goes
    through the optimizer, so weight decay moves the body too.  Returns the
    model and each step's loss."""
    model = copy.deepcopy(base)
    dev = next(model.parameters()).device
    opt = make_optimizer(dataclasses.replace(pretrain_experiment().train,
                                             total_steps=HEAD_STEPS))
    params = dict(model.named_parameters())
    state = opt.init(params)
    make = batches(TASK_B, 1, dev)
    losses = []
    for i in range(steps):
        loss, _ = lm_loss(model, make(i, 0), remat="none")
        opt.apply(params, head_grads(model, loss), state, i)
        losses.append(float(loss.detach()))
    return model, losses


def e2_finetune(base: nn.Module, steps: int = E2_STEPS,
                init: Optional[nn.Module] = None
                ) -> Tuple[Trainer, List[Dict[str, float]]]:
    """Option 2: a fresh E2-Train state (seed 2, or ``init``) whose every
    parameter that ``base`` has is copied from it, trained ``steps``
    nominal steps on task B (data seed 1)."""
    dev = next(base.parameters()).device
    exp = e2_experiment()
    state = init_train_state(exp, seed=2, device=dev) if init is None \
        else train_state_for(exp, init)
    body = dict(base.named_parameters())
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            if n in body:
                p.copy_(body[n])
    trainer = Trainer(exp, state, batches(TASK_B, 1, dev), device=dev)
    return trainer, trainer.run(steps)


def energy_units(trainer: Trainer, steps: int) -> float:
    """Executed steps times the run's PSG factor (measured, else assumed)
    times the executed share of the gated layers."""
    rep = trainer.energy_report(steps=steps)
    factor = rep.psg_factor_measured if rep.psg_factor_measured is not None \
        else rep.psg_factor_assumed
    if rep.slu.resolved() is not None:
        factor *= 1.0 - rep.slu.resolved()
    return trainer.executed_steps * factor


def run(device=None, pretrain_steps: int = PRETRAIN_STEPS,
        head_steps: int = HEAD_STEPS, e2_steps: int = E2_STEPS) -> dict:
    """The three stages, with the reference's prints; returns the record."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    trainer, pre = pretrain(pretrain_steps, dev)
    base = trainer.state.model
    before = eval_loss(base, TASK_B)
    print(f"pre-trained on A; loss on B before FT: {before:.4f}")
    model1, head = head_only(base, head_steps)
    l1 = eval_loss(model1, TASK_B)
    tr2, fine = e2_finetune(base, e2_steps)
    l2 = eval_loss(tr2.state.model, TASK_B)
    e1 = head_steps * 1.0
    e2_cost = energy_units(tr2, e2_steps)
    reproduced = bool(l2 <= l1 and e2_cost < e1)
    print(f"option 1 (standard FT):  loss on B = {l1:.4f}, "
          f"energy units = {e1:.0f}")
    print(f"option 2 (E2-Train FT):  loss on B = {l2:.4f}, "
          f"energy units = {e2_cost:.0f} "
          f"({1 - e2_cost/e1:.0%} less energy)")
    print("paper §4.5: E2-Train fine-tuning wins on accuracy AND energy"
          f" -> reproduced: {reproduced}")
    return {"pretrain_losses": [h["loss"] for h in pre],
            "loss_on_b_before": before, "head_only_losses": head,
            "e2_losses": [h["loss"] for h in fine],
            "e2_executed": tr2.executed_steps,
            "e2_dropped": tr2.dropped_steps,
            "option1_loss": l1, "option2_loss": l2,
            "option1_energy_units": e1, "option2_energy_units": e2_cost,
            "reproduced": reproduced}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises without a card)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
