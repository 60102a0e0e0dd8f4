"""Train a CIFAR ResNet or a transformer LM with SMD, SLU and PSG and print
the energy report.

    python -m repro_torch.launch.train --depth 74 --batch 128 --steps 8
    python -m repro_torch.launch.train --depth 8 --width 8 --batch 4 \\
        --steps 4 --device cpu
    python -m repro_torch.launch.train --task lm --arch qwen2_5_3b --smoke \\
        --steps 6 --device cpu
    python -m repro_torch.launch.train --task lm --fused-attention on \\
        --batch 2 --seq 4096 --steps 8

The counterparts of ``examples/train_e2e.py --task cifar_cnn`` and of
``repro.launch.train --arch ... --e2train full`` in the JAX package:
SMD p=0.5, SLU on, PSG on with the ``psg`` optimizer (signSGD, lr 0.03),
per-step loop, synthetic data (Gaussian CIFAR images; Markov-chain tokens).
``--smoke`` cuts the LM to toy dimensions (``configs.reduce_experiment``);
``--fused-attention on`` trains the LM through the flash kernels with the
PSG dk/dv backward (``PSGConfig.fused_attention=True``), ``off`` and
``auto`` through the materialized softmax.  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_experiment, reduce_experiment
from repro_torch.configs.paper_cnns import cnn_model
from repro_torch.core.config import (E2TrainConfig, Experiment, PSGConfig,
                                     SLUConfig, SMDConfig, TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import (GaussianImageTask, MarkovLMTask,
                                        make_image_batch, make_lm_batch)
from repro_torch.training.train_step import init_train_state
from repro_torch.training.trainer import Trainer

FUSED_ATTENTION = {"auto": None, "on": True, "off": False}
FULL_E2 = E2TrainConfig(smd=SMDConfig(enabled=True, drop_prob=0.5),
                        slu=SLUConfig(enabled=True, alpha=1e-3),
                        psg=PSGConfig(enabled=True))


def _fp32_is_fp32() -> None:
    # fp32 means fp32 wherever the port runs plain PyTorch math on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def experiment(depth: int, width: int, batch: int, steps: int) -> Experiment:
    tcfg = TrainConfig(global_batch=batch, lr=0.03, optimizer="psg",
                       total_steps=steps, schedule="step", microbatches=1)
    return Experiment(model=cnn_model(f"resnet{depth}", depth, width=width),
                      e2=FULL_E2, train=tcfg, task="cifar_cnn")


def build_trainer(depth: int = 74, width: int = 16, batch: int = 128,
                  steps: int = 8, device=None, seed: int = 0) -> Trainer:
    """The ResNet trainer the CLI runs: model from ``seed``, data seed 0."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    exp = experiment(depth, width, batch, steps)
    state = init_train_state(exp, seed=seed, device=dev)
    img_task = GaussianImageTask(num_classes=10, snr=2.0)

    def make_batch(step, shard):
        return make_image_batch(img_task, 0, step, shard, batch, dev)

    return Trainer(exp, state, make_batch, device=dev)


def lm_experiment(arch: str, num_layers: Optional[int] = None,
                  batch: Optional[int] = None, seq: Optional[int] = None,
                  steps: int = 8, smoke: bool = False,
                  fused_attention: Optional[bool] = None) -> Experiment:
    """``arch`` under ``--e2train full`` (optimizer ``psg``, lr 0.03);
    ``smoke`` reduces it to toy dimensions first, ``num_layers`` cuts the
    depth, ``batch``/``seq`` default to the experiment's, and
    ``fused_attention`` is ``PSGConfig.fused_attention``."""
    exp = get_experiment(arch)
    if smoke:
        exp = reduce_experiment(exp)
    model = exp.model if num_layers is None else \
        dataclasses.replace(exp.model, num_layers=num_layers)
    tcfg = dataclasses.replace(
        exp.train, optimizer="psg", lr=0.03, total_steps=steps,
        global_batch=batch or exp.train.global_batch,
        seq_len=seq or exp.train.seq_len)
    e2 = dataclasses.replace(FULL_E2, psg=dataclasses.replace(
        FULL_E2.psg, fused_attention=fused_attention))
    return exp.replace(model=model, e2=e2, train=tcfg, task="lm")


def build_lm_trainer(arch: str = "qwen2_5_3b",
                     num_layers: Optional[int] = None,
                     batch: Optional[int] = None, seq: Optional[int] = None,
                     steps: int = 8, device=None, seed: int = 0,
                     smoke: bool = False,
                     fused_attention: Optional[bool] = None) -> Trainer:
    """The LM trainer the CLI runs: model from ``seed`` on ``device``,
    Markov-chain tokens from the experiment's seed."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    exp = lm_experiment(arch, num_layers, batch, seq, steps, smoke,
                        fused_attention)
    state = init_train_state(exp, seed=seed, device=dev)
    tc = exp.train
    task = MarkovLMTask(vocab=exp.model.vocab_size)

    def make_batch(step, shard):
        return make_lm_batch(task, tc.seed, step, shard, tc.global_batch,
                             tc.seq_len, dev)

    return Trainer(exp, state, make_batch, device=dev)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", choices=["cifar_cnn", "lm"], default="cifar_cnn")
    ap.add_argument("--arch", default="qwen2_5_3b",
                    help="LM architecture (--task lm)")
    ap.add_argument("--smoke", action="store_true",
                    help="toy-sized LM (--task lm)")
    ap.add_argument("--fused-attention", choices=list(FUSED_ATTENTION),
                    default="auto",
                    help="PSGConfig.fused_attention (--task lm): on = the "
                         "flash kernels, off and auto = the materialized "
                         "softmax")
    ap.add_argument("--depth", type=int, default=74,
                    help="CIFAR ResNet depth (6n+2)")
    ap.add_argument("--width", type=int, default=16, help="stage-0 width")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 128 images, or the LM experiment's batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="LM sequence length (default: the experiment's)")
    ap.add_argument("--steps", type=int, default=8,
                    help="nominal steps (SMD drops about half)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    if args.task == "lm":
        trainer = build_lm_trainer(args.arch, batch=args.batch, seq=args.seq,
                                   steps=args.steps, device=args.device,
                                   smoke=args.smoke,
                                   fused_attention=FUSED_ATTENTION[
                                       args.fused_attention])
        tc = trainer.exp.train
        attn = "flash" if trainer.exp.e2.psg.fused_attention else \
            "materialized"
        print(f"model {trainer.exp.model.name} ({trainer.exp.model.num_layers}"
              f" layers, d_model {trainer.exp.model.d_model}, batch "
              f"{tc.global_batch} x seq {tc.seq_len}, {attn} attention) on "
              f"{trainer.device}")
    else:
        batch = args.batch or 128
        trainer = build_trainer(args.depth, args.width, batch, args.steps,
                                args.device)
        print(f"model {trainer.exp.model.name} (CIFAR shapes, width "
              f"{args.width}, batch {batch}) on {trainer.device}")
    hist = trainer.run(args.steps, log_every=1)
    if hist:
        fb = trainer.measured_psg_fallback()
        print(f"\nfinal loss {np.mean([h['loss'] for h in hist[-5:]]):.4f}; "
              f"executed {trainer.executed_steps}, "
              f"SMD-dropped {trainer.dropped_steps}; "
              f"measured PSG fallback {fb:.3f}")
        print(f"throughput: {trainer.steps_per_s():.3f} executed steps/s "
              "(per-step loop; the first step includes the kernel build)")
        print("\n" + trainer.energy_report(steps=args.steps).summary())
    return trainer


if __name__ == "__main__":
    main()
