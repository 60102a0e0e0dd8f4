"""Train a CIFAR ResNet with SMD, SLU and PSG and print the energy report.

    python -m repro_torch.launch.train --depth 74 --batch 128 --steps 8
    python -m repro_torch.launch.train --depth 8 --width 8 --batch 4 \\
        --steps 4 --device cpu

The counterpart of ``examples/train_e2e.py --task cifar_cnn`` in the JAX
package: synthetic Gaussian CIFAR images, SMD p=0.5, SLU on, PSG on with the
``psg`` optimizer (signSGD, lr 0.03), per-step loop.  Runs on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.paper_cnns import cnn_model
from repro_torch.core.config import (E2TrainConfig, Experiment, PSGConfig,
                                     SLUConfig, SMDConfig, TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import GaussianImageTask, make_image_batch
from repro_torch.training.train_step import init_train_state
from repro_torch.training.trainer import Trainer


def experiment(depth: int, width: int, batch: int, steps: int) -> Experiment:
    e2 = E2TrainConfig(smd=SMDConfig(enabled=True, drop_prob=0.5),
                       slu=SLUConfig(enabled=True, alpha=1e-3),
                       psg=PSGConfig(enabled=True))
    tcfg = TrainConfig(global_batch=batch, lr=0.03, optimizer="psg",
                       total_steps=steps, schedule="step", microbatches=1)
    return Experiment(model=cnn_model(f"resnet{depth}", depth, width=width),
                      e2=e2, train=tcfg, task="cifar_cnn")


def build_trainer(depth: int = 74, width: int = 16, batch: int = 128,
                  steps: int = 8, device=None, seed: int = 0) -> Trainer:
    """The trainer the CLI runs: model from ``seed``, data seed 0."""
    dev = resolve_device(device)
    # fp32 means fp32 wherever the port runs plain PyTorch math on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = experiment(depth, width, batch, steps)
    state = init_train_state(exp, seed=seed, device=dev)
    img_task = GaussianImageTask(num_classes=10, snr=2.0)

    def make_batch(step, shard):
        return make_image_batch(img_task, 0, step, shard, batch, dev)

    return Trainer(exp, state, make_batch, device=dev)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth", type=int, default=74,
                    help="CIFAR ResNet depth (6n+2)")
    ap.add_argument("--width", type=int, default=16, help="stage-0 width")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8,
                    help="nominal steps (SMD drops about half)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    trainer = build_trainer(args.depth, args.width, args.batch, args.steps,
                            args.device)
    print(f"model {trainer.exp.model.name} (CIFAR shapes, width "
          f"{args.width}, batch {args.batch}) on {trainer.device}")
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
