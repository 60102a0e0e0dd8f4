"""Quickstart: a small LM trained with full E2-Train, SMD + SLU + PSG (the
JAX package's ``examples/quickstart.py``).

    python -m repro_torch.launch.quickstart [--device cpu]

Trains the 4-layer d-64 LM on the learnable Markov task: first the 32-bit
SGD baseline (sgdm at lr 0.1, 60 steps), then full E2-Train (SMD at drop
0.5, SLU at alpha 1e-3 and target skip 0.2, PSG with SWA; the ``psg``
optimizer at lr 0.03, 120 nominal steps), and prints the E2-Train run's
energy report (its measured telemetry beside the config's assumed
operating point) and the paper's Tab. 3 composition at SLU skip 0.2, 0.4
and 0.6 from the config alone.  Each stage is a function of its step
count, so tests can run it short.  Runs on the card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from torch import nn

from repro_torch.core.config import (E2TrainConfig, Experiment, ModelConfig,
                                     PSGConfig, SLUConfig, SMDConfig,
                                     TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.core.ledger import EnergyLedger
from repro_torch.data.synthetic import MarkovLMTask, make_lm_batch
from repro_torch.launch.train import _fp32_is_fp32
from repro_torch.training.train_step import init_train_state, \
    train_state_for
from repro_torch.training.trainer import Trainer

MODEL = ModelConfig(name="quickstart", family="dense", num_layers=4,
                    d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                    vocab_size=64, dtype="float32")
TASK = MarkovLMTask(vocab=64)
BATCH, SEQ = 16, 32
BASELINE_STEPS, E2_STEPS = 60, 120
E2 = E2TrainConfig(smd=SMDConfig(enabled=True, drop_prob=0.5),
                   slu=SLUConfig(enabled=True, alpha=1e-3, target_skip=0.2),
                   psg=PSGConfig(enabled=True))
TAB3 = ((0.2, "80.27%"), (0.4, "85.20%"), (0.6, "90.13%"))


def experiment(e2: E2TrainConfig, optimizer: str, lr: float,
               steps: int) -> Experiment:
    return Experiment(model=MODEL, e2=e2, train=TrainConfig(
        global_batch=BATCH, seq_len=SEQ, lr=lr, optimizer=optimizer,
        total_steps=steps, schedule="constant"))


def train(tag: str, e2: E2TrainConfig, optimizer: str, lr: float,
          steps: int, device=None, init: Optional[nn.Module] = None,
          log_every: int = 20) -> Tuple[Trainer, List[Dict[str, float]]]:
    """``steps`` nominal steps from seed 0 (or ``init``) on data seed 0;
    prints the reference's summary line."""
    dev = resolve_device(device)
    exp = experiment(e2, optimizer, lr, steps)
    state = init_train_state(exp, seed=0, device=dev) if init is None \
        else train_state_for(exp, init)
    trainer = Trainer(exp, state, lambda step, shard: make_lm_batch(
        TASK, 0, step, shard, BATCH, SEQ, dev), device=dev)
    hist = trainer.run(steps, log_every=log_every)
    final = np.mean([h["loss"] for h in hist[-5:]])
    print(f"[{tag}] final loss {final:.4f} "
          f"(executed {trainer.executed_steps}, SMD-dropped "
          f"{trainer.dropped_steps}, bayes floor {TASK.bayes_xent():.3f})")
    return trainer, hist


def table3() -> List[Tuple[float, float, str]]:
    """``(SLU skip, computational savings, the paper's)`` of the Tab. 3
    operating points, from the config alone."""
    rows = []
    for skip, paper in TAB3:
        op = E2TrainConfig(smd=SMDConfig(enabled=True, drop_prob=0.5),
                           slu=SLUConfig(enabled=True, target_skip=skip),
                           psg=PSGConfig(enabled=True))
        rep = EnergyLedger(Experiment(model=MODEL, e2=op)).report()
        rows.append((skip, rep.paper_composition, paper))
    return rows


def run(device=None, baseline_steps: int = BASELINE_STEPS,
        e2_steps: int = E2_STEPS) -> dict:
    """The three parts, with the reference's prints; returns the record."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    print("=== baseline: 32-bit SGD ===")
    _, base = train("sgd32", E2TrainConfig(), "sgdm", 0.1, baseline_steps,
                    dev)
    print("\n=== E2-Train: SMD + SLU + PSG (SignSGD+SWA) ===")
    tr, e2 = train("e2train", E2, "psg", 0.03, e2_steps, dev)
    print("\n=== energy accounting: this run, measured vs assumed ===")
    report = tr.energy_report(steps=e2_steps)
    print(report.summary())
    print("\n=== energy accounting (paper Tab. 3 composition) ===")
    tab3 = table3()
    for skip, comp, paper in tab3:
        print(f"  SLU skip {skip:.0%}: computational savings = "
              f"{comp:.2%} (paper: {paper})")
    return {"baseline_losses": [h["loss"] for h in base],
            "e2_losses": [h["loss"] for h in e2],
            "e2_executed": tr.executed_steps, "e2_dropped": tr.dropped_steps,
            "comp_saving_measured": report.computational_savings_measured,
            "tab3": [c for _, c, _ in tab3]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises without a card)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
