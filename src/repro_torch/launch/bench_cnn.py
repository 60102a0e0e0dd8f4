"""Paper Tab. 4: E2-Train on the paper's own backbones, a CIFAR ResNet and
MobileNetV2.

    python -m repro_torch.launch.bench_cnn [--fast] [--steps N] [--device cpu]

The counterpart of the JAX package's ``benchmarks/bench_cnn.py``
(``run(fast)``), with its row names, sizes and derived fields; each row is
``name,us_per_call,derived`` CSV:

* ``tab4/resnet{depth}_smb``: the baseline (E2-Train off, SGD with momentum
  at lr 0.1) over ``steps`` nominal steps: microseconds per executed step,
  held-out accuracy (``training/evaluate.py``) and the energy fields;
* ``tab4/resnet{depth}_e2train``: SMD, SLU (alpha 5e-3, target skip 0.2)
  and PSG (no SWA) with the ``psg`` optimizer at lr 0.03 over ``2 steps``
  nominal steps, priced over ``steps`` as the reference prices it, with
  ``paper=0.8027`` and the measured PSG fallback;
* ``tab4/mobilenetv2_fwd``: one train-mode forward of MobileNetV2 (seed
  2) on a batch of 8 images, and whether its logits are finite.

Sizes: ``--fast`` is depth 14 and 80 baseline steps, full depth 26 and 240,
both at batch 16 with the step schedule and weight decay 5e-4; ``--steps``
cuts the baseline's nominal steps (the E2-Train row runs twice as many).
Runs on the card unless ``--device cpu`` is given; a time is the host's
clock around work that ends in a synchronize, on the device the rows ran
on (a training row's first step includes the kernel build, as the
reference's includes its compile; the forward is timed after one warm-up
call).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.paper_cnns import cnn_model
from repro_torch.core.config import (E2TrainConfig, Experiment, PSGConfig,
                                     SLUConfig, SMDConfig, TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import GaussianImageTask, make_image_batch
from repro_torch.launch.bench_common import csv_row, energy_fields, sync
from repro_torch.launch.train import _fp32_is_fp32
from repro_torch.models.resnet import MobileNetV2
from repro_torch.training import evaluate
from repro_torch.training.train_step import eval_params, init_train_state
from repro_torch.training.trainer import Trainer

TASK = GaussianImageTask(num_classes=10, snr=2.0)
BATCH = 16
PAPER_SAVING = 0.8027       # Tab. 3/4: SMD + SLU at 20% skip + PSG


def _cnn_experiment(depth: int, e2: E2TrainConfig, steps: int, *,
                    optimizer: str = "sgdm", lr: float = 0.1) -> Experiment:
    return Experiment(
        model=cnn_model(f"resnet{depth}", depth), e2=e2,
        train=TrainConfig(global_batch=BATCH, lr=lr, optimizer=optimizer,
                          total_steps=steps, schedule="step",
                          weight_decay=5e-4),
        task="cifar_cnn")


def _train_resnet(depth: int, e2: E2TrainConfig, steps: int,
                  dev: torch.device, *, optimizer: str = "sgdm",
                  lr: float = 0.1):
    """``(held-out accuracy, executed steps, wall s, trainer)``."""
    exp = _cnn_experiment(depth, e2, steps, optimizer=optimizer, lr=lr)
    trainer = Trainer(exp, init_train_state(exp, seed=0, device=dev),
                      lambda s, sh: make_image_batch(TASK, 0, s, sh, BATCH,
                                                     dev), device=dev)
    sync(dev)
    t0 = time.perf_counter()
    trainer.run(steps)
    sync(dev)
    wall = time.perf_counter() - t0
    # eval mode with the BatchNorm statistics of the run
    acc = evaluate.accuracy(exp, eval_params(trainer.state, exp), dev)
    return acc, trainer.executed_steps, wall, trainer


def _mobilenet_fwd(dev: torch.device):
    """``(microseconds, logits)`` of one train-mode forward at batch 8."""
    model = MobileNetV2(seed=2).to(dev)
    image = make_image_batch(TASK, 0, 0, 0, 8, dev)["image"]
    with torch.no_grad():
        model(image)                     # warm-up
        sync(dev)
        t0 = time.perf_counter()
        logits, _ = model(image)
        sync(dev)
    return (time.perf_counter() - t0) * 1e6, logits


def run(fast: bool = True, device=None, steps: Optional[int] = None
        ) -> List[str]:
    dev = resolve_device(device)
    _fp32_is_fp32()
    depth = 14 if fast else 26          # reduced ResNet (6n+2 family)
    steps = steps or (80 if fast else 240)
    rows = []
    acc, n, wall, tr0 = _train_resnet(depth, E2TrainConfig(), steps, dev)
    rows.append(csv_row(f"tab4/resnet{depth}_smb", wall / max(n, 1) * 1e6,
                        f"acc={acc:.4f};{energy_fields(tr0, steps=steps)}"))
    e2 = E2TrainConfig(smd=SMDConfig(True),
                       slu=SLUConfig(True, alpha=5e-3, target_skip=0.2),
                       psg=PSGConfig(True, swa=False))
    acc2, n2, wall2, tr2 = _train_resnet(depth, e2, 2 * steps, dev,
                                         optimizer="psg", lr=0.03)
    rows.append(csv_row(f"tab4/resnet{depth}_e2train",
                        wall2 / max(n2, 1) * 1e6,
                        f"acc={acc2:.4f};{energy_fields(tr2, steps=steps)};"
                        f"paper={PAPER_SAVING};"
                        f"measured_psg_fallback={tr2.measured_psg_fallback()}"))
    us, logits = _mobilenet_fwd(dev)
    finite = bool(np.isfinite(logits.cpu().numpy()).all())
    rows.append(csv_row("tab4/mobilenetv2_fwd", us,
                        f"logits_finite={finite}"))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="depth 14 and 80 baseline steps (else 26 and 240)")
    ap.add_argument("--steps", type=int, default=None,
                    help="baseline nominal steps (the E2-Train row runs "
                         "twice as many)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# Tab. 4 benchmark on {where}; name,us_per_call,derived",
          flush=True)
    rows = run(fast=args.fast, device=dev, steps=args.steps)
    for row in rows:
        print(row, flush=True)
    return rows


if __name__ == "__main__":
    main()
