"""Train a CIFAR ResNet or a transformer LM with SMD, SLU and PSG and print
the energy report.

    python -m repro_torch.launch.train --depth 74 --batch 128 --steps 8
    python -m repro_torch.launch.train --depth 8 --width 8 --batch 4 \\
        --steps 4 --device cpu
    python -m repro_torch.launch.train --task lm --arch qwen2_5_3b --smoke \\
        --steps 6 --device cpu
    python -m repro_torch.launch.train --task lm --fused-attention on \\
        --batch 2 --seq 4096 --steps 8
    python -m repro_torch.launch.train --depth 74 --e2train off \\
        --fused-conv off --steps 8

The counterparts of ``examples/train_e2e.py --task cifar_cnn`` and of
``repro.launch.train --arch ... --e2train ...`` in the JAX package, with a
per-step loop and synthetic data (Gaussian CIFAR images; Markov-chain
tokens).  ``--e2train`` picks the techniques as the JAX package does:
``full`` (the default: SMD p=0.5, SLU on, PSG on), ``smd``, ``slu``, ``psg``
or ``off``; with PSG on the optimizer is ``psg`` (signSGD, lr 0.03),
otherwise the experiment's own (the CIFAR ResNet: SGD with momentum, lr
0.1).  ``--fused-conv`` picks the ResNet's conv path
(``PSGConfig.fused_conv``): ``on`` and ``auto`` the implicit-GEMM conv
kernels, ``off`` the materialized im2col on the PSG matmul kernels.
``--smoke`` cuts the LM to toy dimensions (``configs.reduce_experiment``);
``--fused-attention on`` trains the LM through the flash kernels with the
PSG dk/dv backward (``PSGConfig.fused_attention=True``), ``off`` and
``auto`` through the materialized softmax.  Runs on the card unless
``--device cpu`` is given.  The header line names the kernel backend
(``kernels/dispatch.py``: ``auto`` unless ``REPRO_TORCH_KERNEL_BACKEND``
pins another), with a warning on stderr when a pin runs the plain versions
or the oracles on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_experiment, reduce_experiment
from repro_torch.configs.paper_cnns import cnn_model, cnn_train
from repro_torch.core.config import (E2TrainConfig, Experiment, PSGConfig,
                                     SLUConfig, SMDConfig, TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.core.psg import fused_conv_active
from repro_torch.data.synthetic import (GaussianImageTask, MarkovLMTask,
                                        make_image_batch, make_lm_batch)
from repro_torch.kernels import dispatch
from repro_torch.training.train_step import init_train_state
from repro_torch.training.trainer import Trainer

FUSED = {"auto": None, "on": True, "off": False}    # --fused-{conv,attention}
FULL_E2 = E2TrainConfig(smd=SMDConfig(enabled=True, drop_prob=0.5),
                        slu=SLUConfig(enabled=True, alpha=1e-3),
                        psg=PSGConfig(enabled=True))
E2TRAIN = {"off": E2TrainConfig(), "full": FULL_E2,
           "smd": E2TrainConfig(smd=SMDConfig(enabled=True)),
           "slu": E2TrainConfig(slu=SLUConfig(enabled=True)),
           "psg": E2TrainConfig(psg=PSGConfig(enabled=True))}


def _fp32_is_fp32() -> None:
    # fp32 means fp32 wherever the port runs plain PyTorch math on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _for_e2(tcfg: TrainConfig, e2: E2TrainConfig) -> TrainConfig:
    """The JAX package's ``--e2train`` rule: with PSG on, the ``psg``
    optimizer at lr 0.03; otherwise ``tcfg`` as it is."""
    if e2.psg.enabled:
        return dataclasses.replace(tcfg, optimizer="psg", lr=0.03)
    return tcfg


def experiment(depth: int, width: int, batch: int, steps: int,
               e2: E2TrainConfig = FULL_E2,
               fused_conv: Optional[bool] = None) -> Experiment:
    """CIFAR ResNet-``depth`` under ``e2`` (an :data:`E2TRAIN` preset) with
    ``PSGConfig.fused_conv = fused_conv``; the paper's training config
    (``configs.paper_cnns``) cut to ``batch`` and ``steps``."""
    tcfg = dataclasses.replace(cnn_train(), global_batch=batch,
                               total_steps=steps)
    e2 = dataclasses.replace(e2, psg=dataclasses.replace(
        e2.psg, fused_conv=fused_conv))
    return Experiment(model=cnn_model(f"resnet{depth}", depth, width=width),
                      e2=e2, train=_for_e2(tcfg, e2), task="cifar_cnn")


def build_trainer(depth: int = 74, width: int = 16, batch: int = 128,
                  steps: int = 8, device=None, seed: int = 0,
                  e2: E2TrainConfig = FULL_E2,
                  fused_conv: Optional[bool] = None) -> Trainer:
    """The ResNet trainer the CLI runs: model from ``seed``, data seed 0."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    exp = experiment(depth, width, batch, steps, e2, fused_conv)
    state = init_train_state(exp, seed=seed, device=dev)
    img_task = GaussianImageTask(num_classes=10, snr=2.0)

    def make_batch(step, shard):
        return make_image_batch(img_task, 0, step, shard, batch, dev)

    return Trainer(exp, state, make_batch, device=dev)


def lm_experiment(arch: str, num_layers: Optional[int] = None,
                  batch: Optional[int] = None, seq: Optional[int] = None,
                  steps: int = 8, smoke: bool = False,
                  fused_attention: Optional[bool] = None,
                  e2: E2TrainConfig = FULL_E2) -> Experiment:
    """``arch`` under ``e2`` (an :data:`E2TRAIN` preset; with PSG on, the
    ``psg`` optimizer at lr 0.03); ``smoke`` reduces it to toy dimensions
    first, ``num_layers`` cuts the depth, ``batch``/``seq`` default to the
    experiment's, and ``fused_attention`` is ``PSGConfig.fused_attention``."""
    exp = get_experiment(arch)
    if smoke:
        exp = reduce_experiment(exp)
    model = exp.model if num_layers is None else \
        dataclasses.replace(exp.model, num_layers=num_layers)
    tcfg = dataclasses.replace(
        exp.train, total_steps=steps,
        global_batch=batch or exp.train.global_batch,
        seq_len=seq or exp.train.seq_len)
    e2 = dataclasses.replace(e2, psg=dataclasses.replace(
        e2.psg, fused_attention=fused_attention))
    return exp.replace(model=model, e2=e2, train=_for_e2(tcfg, e2),
                       task="lm")


def build_lm_trainer(arch: str = "qwen2_5_3b",
                     num_layers: Optional[int] = None,
                     batch: Optional[int] = None, seq: Optional[int] = None,
                     steps: int = 8, device=None, seed: int = 0,
                     smoke: bool = False,
                     fused_attention: Optional[bool] = None,
                     e2: E2TrainConfig = FULL_E2) -> Trainer:
    """The LM trainer the CLI runs: model from ``seed`` on ``device``,
    Markov-chain tokens from the experiment's seed."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    exp = lm_experiment(arch, num_layers, batch, seq, steps, smoke,
                        fused_attention, e2)
    state = init_train_state(exp, seed=seed, device=dev)
    tc = exp.train
    task = MarkovLMTask(vocab=exp.model.vocab_size)

    def make_batch(step, shard):
        return make_lm_batch(task, tc.seed, step, shard, tc.global_batch,
                             tc.seq_len, dev)

    return Trainer(exp, state, make_batch, device=dev)


def kernel_backend(trainer: Trainer) -> str:
    """The kernel backend the trainer's PSG ops resolve to; warns on stderr
    when a pin runs the plain versions or the oracles on the card, whose
    step times are then not those of the kernels."""
    backend = dispatch.resolve_backend(trainer.exp.e2.psg)
    if trainer.device.type == "cuda" and backend not in ("auto", "cuda"):
        print(f"warning: kernel backend {backend!r} (PSGConfig.backend or "
              "REPRO_TORCH_KERNEL_BACKEND) runs the "
              + ("plain versions" if backend == "plain" else "oracles")
              + " on the card in place of the kernels", file=sys.stderr)
    return backend


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", choices=["cifar_cnn", "lm"], default="cifar_cnn")
    ap.add_argument("--arch", default="qwen2_5_3b",
                    help="LM architecture (--task lm)")
    ap.add_argument("--smoke", action="store_true",
                    help="toy-sized LM (--task lm)")
    ap.add_argument("--e2train", choices=list(E2TRAIN), default="full",
                    help="E2-Train techniques: full = SMD + SLU + PSG, or "
                         "one of them alone, or off")
    ap.add_argument("--fused-attention", choices=list(FUSED), default="auto",
                    help="PSGConfig.fused_attention (--task lm): on = the "
                         "flash kernels, off and auto = the materialized "
                         "softmax")
    ap.add_argument("--fused-conv", choices=list(FUSED), default="auto",
                    help="PSGConfig.fused_conv (--task cifar_cnn): on = "
                         "the implicit-GEMM conv kernels, off = the "
                         "materialized im2col; auto leaves it to "
                         "core/psg.fused_conv_active, which picks the "
                         "kernels on every device the port runs on (the "
                         "JAX package's auto picks im2col on the TPU)")
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
    e2 = E2TRAIN[args.e2train]
    psg_cfg = e2.psg if e2.psg.enabled else None
    if args.task == "lm":
        fused = FUSED[args.fused_attention]
        trainer = build_lm_trainer(args.arch, batch=args.batch, seq=args.seq,
                                   steps=args.steps, device=args.device,
                                   smoke=args.smoke, fused_attention=fused,
                                   e2=e2)
        tc = trainer.exp.train
        attn = "flash" if psg_cfg and fused else "materialized"
        print(f"model {trainer.exp.model.name} ({trainer.exp.model.num_layers}"
              f" layers, d_model {trainer.exp.model.d_model}, batch "
              f"{tc.global_batch} x seq {tc.seq_len}, {attn} attention, "
              f"--e2train {args.e2train}, kernel backend "
              f"{kernel_backend(trainer)}) on {trainer.device}")
    else:
        batch = args.batch or 128
        trainer = build_trainer(args.depth, args.width, batch, args.steps,
                                args.device, e2=e2,
                                fused_conv=FUSED[args.fused_conv])
        conv = "fused" if fused_conv_active(trainer.exp.e2.psg
                                            if psg_cfg else None) \
            else "im2col"
        print(f"model {trainer.exp.model.name} (CIFAR shapes, width "
              f"{args.width}, batch {batch}, {conv} conv, --e2train "
              f"{args.e2train}, kernel backend {kernel_backend(trainer)}) "
              f"on {trainer.device}")
    hist = trainer.run(args.steps, log_every=1)
    if hist:
        fb = trainer.measured_psg_fallback()
        print(f"\nfinal loss {np.mean([h['loss'] for h in hist[-5:]]):.4f}; "
              f"executed {trainer.executed_steps}, "
              f"SMD-dropped {trainer.dropped_steps}; measured PSG fallback "
              + ("none (PSG off)" if fb is None else f"{fb:.3f}"))
        print(f"throughput: {trainer.steps_per_s():.3f} executed steps/s "
              "(per-step loop; the first step includes the kernel build)")
        print("\n" + trainer.energy_report(steps=args.steps).summary())
    return trainer


if __name__ == "__main__":
    main()
