"""Train a CIFAR ResNet, MobileNetV2 or a transformer LM with SMD, SLU and
PSG and print the energy report.

    python -m repro_torch.launch.train --depth 74 --batch 128 --steps 8
    python -m repro_torch.launch.train --cnn mobilenetv2 --steps 8
    python -m repro_torch.launch.train --cnn mobilenetv2 --batch 2 \\
        --steps 2 --device cpu
    python -m repro_torch.launch.train --depth 8 --width 8 --batch 4 \\
        --steps 4 --device cpu
    python -m repro_torch.launch.train --task lm --arch qwen2_5_3b --smoke \\
        --steps 6 --device cpu
    python -m repro_torch.launch.train --task lm --fused-attention on \\
        --batch 2 --seq 4096 --steps 8
    python -m repro_torch.launch.train --depth 74 --e2train off \\
        --fused-conv off --steps 8
    python -m repro_torch.launch.train --depth 8 --width 8 --batch 4 \\
        --steps 6 --device cpu --ckpt /tmp/ck --ckpt-every 2
    python -m repro_torch.launch.train --depth 8 --width 8 --batch 4 \\
        --steps 10 --device cpu --ckpt /tmp/ck --resume
    python -m repro_torch.launch.train --depth 74 --steps 24 --chunk-steps 4

The counterparts of ``examples/train_e2e.py --task cifar_cnn`` and of
``repro.launch.train --arch ... --e2train ...`` in the JAX package, with a
per-step loop and synthetic data (Gaussian CIFAR images; Markov-chain
tokens).  ``--e2train`` picks the techniques as the JAX package does:
``full`` (the default: SMD p=0.5, SLU on, PSG on), ``smd``, ``slu``, ``psg``
or ``off``; with PSG on the optimizer is ``psg`` (signSGD, lr 0.03),
otherwise the experiment's own (SGD with momentum, lr 0.1 for the CIFAR
ResNet and 0.05 for MobileNetV2).  ``--cnn`` picks the CIFAR backbone:
``resnet`` (the default; ``--depth`` and ``--width`` apply to it) or
``mobilenetv2`` at its published widths, which has no SLU gate and ignores
SLU as the JAX package does.  ``--fused-conv`` picks the CNN's conv path
(``PSGConfig.fused_conv``): ``on`` and ``auto`` the implicit-GEMM conv
kernels, ``off`` the materialized im2col on the PSG matmul kernels.
``--smoke`` cuts the LM to toy dimensions (``configs.reduce_experiment``);
``--fused-attention on`` trains the LM through the flash kernels with the
PSG dk/dv backward (``PSGConfig.fused_attention=True``), ``off`` through
the materialized softmax, and ``auto`` (the default) leaves ``None`` to
``core/config.fused_attention_active``, which picks the flash kernels as
the JAX package's auto does.  Runs on the card unless
``--device cpu`` is given.  The header line names the kernel backend
(``kernels/dispatch.py``: ``auto`` unless ``REPRO_TORCH_KERNEL_BACKEND``
pins another), with a warning on stderr when a pin runs the plain versions
or the oracles on the card.

Checkpoints and fault tolerance follow the JAX launcher: ``--ckpt DIR``
saves a final checkpoint (and one after every ``--ckpt-every`` steps) in the
JAX package's format; ``--resume`` restores the newest intact one, prints
``resumed from intact step N (counter at M)`` and runs what is left of the
``--steps`` budget (the total nominal steps, so a resumed run ends where an
uninterrupted one does); ``--deadline-s`` turns a step over the deadline
into a forced drop of the next one; ``--ft-kill-at-step`` hard-kills the
process when the data path reaches that step (``ft/faults.kill_at_step``,
for tests).  The process exits 1 when the final save failed.
``--chunk-steps K`` runs the chunked loop (the JAX launcher's flag): on the
card the train step is captured once into a CUDA graph and a chunk is K
replays of it, and the throughput line adds the ms per executed step after
the first chunk; ``--log-every N`` prints every N-th step's loss.  The summary
ends with the held-out accuracy (``training/evaluate.py``) of the SWA
weights when SWA is on, else of the live ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_experiment, reduce_experiment
from repro_torch.configs.paper_cnns import cnn_model, cnn_train, mobilenetv2
from repro_torch.core.config import (E2TrainConfig, Experiment, PSGConfig,
                                     SLUConfig, SMDConfig, TrainConfig,
                                     fused_attention_active)
from repro_torch.core.device import resolve_device
from repro_torch.core.psg import fused_conv_active
from repro_torch.data.synthetic import (host_image_batch, host_lm_batch,
                                       make_image_batch, make_lm_batch)
from repro_torch.ft import faults
from repro_torch.ft.checkpoint import latest_intact_step, restore_checkpoint
from repro_torch.kernels import dispatch
from repro_torch.training import evaluate
from repro_torch.training.train_step import init_train_state
from repro_torch.training.trainer import Trainer

FUSED = {"auto": None, "on": True, "off": False}    # --fused-{conv,attention}
CNNS = ("resnet", "mobilenetv2")                    # --cnn
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
               fused_conv: Optional[bool] = None,
               cnn: str = "resnet") -> Experiment:
    """CIFAR ResNet-``depth`` at stage-0 ``width`` (``cnn="resnet"``) or
    MobileNetV2 (``cnn="mobilenetv2"``, depth and width ignored) under
    ``e2`` (an :data:`E2TRAIN` preset) with ``PSGConfig.fused_conv =
    fused_conv``; the paper's training config (``configs.paper_cnns``) cut
    to ``batch`` and ``steps``."""
    if cnn not in CNNS:
        raise ValueError(f"cnn {cnn!r}: one of {CNNS}")
    base = mobilenetv2() if cnn == "mobilenetv2" else Experiment(
        model=cnn_model(f"resnet{depth}", depth, width=width),
        train=cnn_train(), task="cifar_cnn")
    tcfg = dataclasses.replace(base.train, global_batch=batch,
                               total_steps=steps)
    e2 = dataclasses.replace(e2, psg=dataclasses.replace(
        e2.psg, fused_conv=fused_conv))
    return base.replace(e2=e2, train=_for_e2(tcfg, e2))


def build_trainer(depth: int = 74, width: int = 16, batch: int = 128,
                  steps: int = 8, device=None, seed: int = 0,
                  e2: E2TrainConfig = FULL_E2,
                  fused_conv: Optional[bool] = None, cnn: str = "resnet",
                  **trainer_kw) -> Trainer:
    """The CNN trainer the CLI runs (:func:`experiment`): model from
    ``seed``, data seed 0; ``trainer_kw`` go to :class:`Trainer`
    (checkpoints, deadline, chunking)."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    exp = experiment(depth, width, batch, steps, e2, fused_conv, cnn)
    state = init_train_state(exp, seed=seed, device=dev)
    img_task = evaluate.data_task(exp)

    def make_batch(step, shard):
        return make_image_batch(img_task, 0, step, shard, batch, dev)

    def make_host_batch(step, shard):
        return host_image_batch(img_task, 0, step, shard, batch,
                                pin=dev.type == "cuda")

    return Trainer(exp, state, make_batch, device=dev,
                   make_host_batch=make_host_batch, **trainer_kw)


def lm_experiment(arch: str, num_layers: Optional[int] = None,
                  batch: Optional[int] = None, seq: Optional[int] = None,
                  steps: int = 8, smoke: bool = False,
                  fused_attention: Optional[bool] = None,
                  e2: E2TrainConfig = FULL_E2,
                  microbatches: int = 1) -> Experiment:
    """``arch`` under ``e2`` (an :data:`E2TRAIN` preset; with PSG on, the
    ``psg`` optimizer at lr 0.03); ``smoke`` reduces it to toy dimensions
    first, ``num_layers`` cuts the depth, ``batch``/``seq`` default to the
    experiment's, ``fused_attention`` is ``PSGConfig.fused_attention``
    (``True`` the flash kernels, ``False`` the materialized softmax,
    ``None`` auto, which resolves to the flash kernels as in the JAX
    package) and
    ``microbatches`` is ``TrainConfig.microbatches`` (``batch`` is the
    whole step's)."""
    exp = get_experiment(arch)
    if smoke:
        exp = reduce_experiment(exp)
    model = exp.model if num_layers is None else \
        dataclasses.replace(exp.model, num_layers=num_layers)
    tcfg = dataclasses.replace(
        exp.train, total_steps=steps,
        global_batch=batch or exp.train.global_batch,
        seq_len=seq or exp.train.seq_len, microbatches=microbatches)
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
                     e2: E2TrainConfig = FULL_E2, microbatches: int = 1,
                     **trainer_kw) -> Trainer:
    """The LM trainer the CLI runs: model from ``seed`` on ``device``,
    Markov-chain tokens from the experiment's seed; ``trainer_kw`` go to
    :class:`Trainer`."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    exp = lm_experiment(arch, num_layers, batch, seq, steps, smoke,
                        fused_attention, e2, microbatches)
    state = init_train_state(exp, seed=seed, device=dev)
    tc = exp.train
    task = evaluate.data_task(exp)

    def make_batch(step, shard):
        return make_lm_batch(task, tc.seed, step, shard, tc.global_batch,
                             tc.seq_len, dev)

    def make_host_batch(step, shard):
        return host_lm_batch(task, tc.seed, step, shard, tc.global_batch,
                             tc.seq_len, pin=dev.type == "cuda")

    return Trainer(exp, state, make_batch, device=dev,
                   make_host_batch=make_host_batch, **trainer_kw)


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


def chunk_summary(trainer: Trainer) -> str:
    """The chunked loop's ms per executed step after the first chunk (wall,
    and device time between the replays' CUDA events where measured)."""
    k = trainer.chunk_steps
    later = trainer.history[k:]
    if not later:
        return "no chunk after the first"
    wall = 1e3 * float(np.mean([h["wall_s"] for h in later]))
    dev = [h["device_s"] for h in later if "device_s" in h]
    out = f"{wall:.2f} ms per executed step after the first chunk"
    if dev:
        out += f" (device {1e3 * float(np.mean(dev)):.2f} ms)"
    return out


def run(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse ``argv``, build, resume, train and report; returns the
    trainer (``main`` turns it into an exit code)."""
    t_start = time.perf_counter()
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
                         "flash kernels, off = the materialized softmax; "
                         "auto leaves it to "
                         "core/config.fused_attention_active, which picks "
                         "the flash kernels as the JAX package's auto does")
    ap.add_argument("--cnn", choices=CNNS, default="resnet",
                    help="CIFAR backbone (--task cifar_cnn): resnet "
                         "(--depth, --width) or mobilenetv2 at its "
                         "published widths")
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
                    help="total nominal steps (SMD drops about half); a "
                         "resumed run executes the rest")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises without a card)")
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="checkpoint directory (a final save at the end)")
    ap.add_argument("--ckpt-every", type=int, default=0, metavar="N",
                    help="also save after every N-th nominal step")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest intact checkpoint in --ckpt")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-step straggler deadline: a step over it arms "
                         "an SMD-style forced drop (0 = off)")
    ap.add_argument("--chunk-steps", type=int, default=1, metavar="K",
                    help="executed steps per dispatch: K > 1 runs the "
                         "chunked loop (training/loop.py; on the card one "
                         "captured CUDA graph replayed K times), with "
                         "prefetched host batches and one metrics sync "
                         "per chunk")
    ap.add_argument("--log-every", type=int, default=1, metavar="N",
                    help="print every N-th nominal step's loss (0 = none)")
    ap.add_argument("--ft-kill-at-step", type=int, default=None,
                    metavar="STEP",
                    help="fault injection: hard-kill (os._exit) this "
                         "process when the data path reaches STEP "
                         "(ft/faults.kill_at_step; testing only)")
    args = ap.parse_args(argv)
    e2 = E2TRAIN[args.e2train]
    psg_cfg = e2.psg if e2.psg.enabled else None
    ft = dict(checkpoint_dir=args.ckpt, checkpoint_every=args.ckpt_every,
              deadline_s=args.deadline_s, chunk_steps=args.chunk_steps)
    if args.task == "lm":
        fused = FUSED[args.fused_attention]
        trainer = build_lm_trainer(args.arch, batch=args.batch, seq=args.seq,
                                   steps=args.steps, device=args.device,
                                   smoke=args.smoke, fused_attention=fused,
                                   e2=e2, **ft)
        tc = trainer.exp.train
        attn = "flash" if fused_attention_active(
            trainer.exp.e2.psg if psg_cfg else None) else "materialized"
        print(f"model {trainer.exp.model.name} ({trainer.exp.model.num_layers}"
              f" layers, d_model {trainer.exp.model.d_model}, batch "
              f"{tc.global_batch} x seq {tc.seq_len}, {attn} attention, "
              f"--e2train {args.e2train}, kernel backend "
              f"{kernel_backend(trainer)}) on {trainer.device}")
    else:
        batch = args.batch or 128
        trainer = build_trainer(args.depth, args.width, batch, args.steps,
                                args.device, e2=e2,
                                fused_conv=FUSED[args.fused_conv],
                                cnn=args.cnn, **ft)
        conv = "fused" if fused_conv_active(trainer.exp.e2.psg
                                            if psg_cfg else None) \
            else "im2col"
        width = "published widths" if args.cnn == "mobilenetv2" \
            else f"width {args.width}"
        print(f"model {trainer.exp.model.name} (CIFAR shapes, {width}, "
              f"batch {batch}, {conv} conv, --e2train {args.e2train}, "
              f"kernel backend {kernel_backend(trainer)}) on "
              f"{trainer.device}")
    if args.ft_kill_at_step is not None:
        trainer.make_batch = faults.kill_at_step(trainer.make_batch,
                                                 args.ft_kill_at_step)
        trainer.make_host_batch = faults.kill_at_step(
            trainer.make_host_batch, args.ft_kill_at_step)
    start = 0
    if args.resume and args.ckpt and latest_intact_step(args.ckpt) is not None:
        # integrity-verified: falls back past torn or corrupt saves
        _, step = restore_checkpoint(args.ckpt, trainer.state)
        start = trainer.state.step      # the next nominal step
        print(f"resumed from intact step {step} (counter at {start})")
    hist = trainer.run(max(args.steps - start, 0), log_every=args.log_every)
    if hist:
        fb = trainer.measured_psg_fallback()
        print(f"\nfinal loss {np.mean([h['loss'] for h in hist[-5:]]):.4f} "
              f"(mean of the last {min(len(hist), 5)} executed steps' task "
              f"loss); last total_loss {hist[-1]['total_loss']:.4f}; "
              f"executed {trainer.executed_steps}, "
              f"SMD-dropped {trainer.dropped_steps} (straggler-dropped "
              f"{trainer.straggler_dropped_steps}); measured PSG fallback "
              + ("none (PSG off)" if fb is None else f"{fb:.3f}"))
        if args.chunk_steps > 1:
            print(f"throughput: {trainer.steps_per_s():.3f} executed steps/s "
                  f"(chunked K={args.chunk_steps}; the first chunk includes "
                  "the kernel build, the warm-up step and the capture); "
                  + chunk_summary(trainer))
        else:
            print(f"throughput: {trainer.steps_per_s():.3f} executed steps/s "
                  "(per-step loop; the first step includes the kernel "
                  "build)")
        print("\n" + trainer.energy_report(steps=args.steps - start)
              .summary())
    if trainer.save_s:
        print(f"checkpoints: {len(trainer.save_s)} saves, "
              f"{1e3 * float(np.mean(trainer.save_s)):.2f} ms each on the "
              f"training loop (mean; the write is async), to {args.ckpt}")
    acc = evaluate.evaluate(trainer)
    swa = "SWA" if trainer.state.swa is not None else "live"
    n = evaluate.HELDOUT_BATCHES
    shape = f"{evaluate.IMAGE_BATCH} images" if args.task == "cifar_cnn" \
        else f"{evaluate.TOKEN_BATCH} x {evaluate.TOKEN_SEQ} tokens"
    print(f"held-out accuracy {acc:.4f} ({n} batches of {shape}, {swa} "
          f"weights, trainer's BatchNorm statistics)")
    print(f"wall {time.perf_counter() - t_start:.2f} s")
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The CLI: 0, or 1 when the final checkpoint did not land (a run whose
    state was not persisted must not exit green)."""
    trainer = run(argv)
    if trainer.save_errors:
        print(f"final save FAILED: {sorted(trainer.save_errors)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
