"""The benchmarks' shared harness (the JAX package's ``benchmarks/common.py``):
the tiny-but-learnable LM task, timed training runs, held-out accuracy, the
row format and the energy fields.

Every paper table or figure has one module here (``bench_psg`` Tab. 2,
``bench_e2train`` Tab. 3, ``bench_cnn`` Tab. 4, ``bench_smd`` Fig. 3 and
Tab. 1, ``bench_slu`` Fig. 4, ``bench_convergence`` Fig. 5), each a
``run(fast, device)`` that returns ``name,us_per_call,derived`` CSV rows;
``bench_run`` drives them.  The models are reduced, as the reference's are,
and the energy numbers come from the paper's 45nm per-op model
(``core/energy.py``) through the run's ``EnergyReport``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.config import (E2TrainConfig, Experiment, ModelConfig,
                                     TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import MarkovLMTask, make_lm_batch
from repro_torch.launch.train import _fp32_is_fp32
from repro_torch.training import evaluate
from repro_torch.training.train_step import (eval_params, init_train_state,
                                             train_state_for)
from repro_torch.training.trainer import Trainer

TINY = ModelConfig(name="bench", family="dense", num_layers=4, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                   dtype="float32")
TASK = MarkovLMTask(vocab=64)
BATCH, SEQ = 16, 32


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_experiment(e2: E2TrainConfig, steps: int, *, lr: float = 0.1,
                  optimizer: str = "sgdm", seed: int = 0,
                  total_steps: Optional[int] = None,
                  model: ModelConfig = TINY) -> Experiment:
    """The bench model's experiment: batch 16 x 32, the step schedule over
    ``total_steps`` (default ``steps``)."""
    return Experiment(
        model=model, e2=e2,
        train=TrainConfig(global_batch=BATCH, seq_len=SEQ, lr=lr,
                          optimizer=optimizer, schedule="step",
                          total_steps=total_steps or steps, seed=seed))


def run_lm(e2: E2TrainConfig, steps: int, *, lr: float = 0.1,
           optimizer: str = "sgdm", seed: int = 0,
           alpha: float = 1e-3, total_steps: Optional[int] = None,
           model: ModelConfig = TINY, device=None,
           init: Optional[nn.Module] = None
           ) -> Tuple[List[Dict], Trainer, float]:
    """Train the bench model for ``steps`` nominal steps on ``device``
    (default: the card); returns ``(history, trainer, wall seconds)``, the
    wall time on the host's clock around the run, ending in a synchronize.

    The model comes from ``seed`` on the device unless ``init`` (a model on
    that device) is given; the data seed is ``seed``.  ``alpha`` is accepted
    and unused, as in the reference (the SLU weight is the config's).
    """
    del alpha
    dev = resolve_device(device)
    _fp32_is_fp32()
    exp = lm_experiment(e2, steps, lr=lr, optimizer=optimizer, seed=seed,
                        total_steps=total_steps, model=model)
    state = init_train_state(exp, seed=seed, device=dev) if init is None \
        else train_state_for(exp, init)
    trainer = Trainer(exp, state, lambda s, sh: make_lm_batch(
        TASK, seed, s, sh, BATCH, SEQ, dev), device=dev)
    sync(dev)
    t0 = time.perf_counter()
    hist = trainer.run(steps)
    sync(dev)
    return hist, trainer, time.perf_counter() - t0


def final_loss(hist: List[Dict], k: int = 5) -> float:
    return float(np.mean([h["loss"] for h in hist[-k:]])) if hist \
        else float("nan")


def eval_accuracy(trainer: Trainer, n_batches: int = 4) -> float:
    """Next-token top-1 accuracy on held-out synthetic batches (data seed
    999, ``training/evaluate.py``'s protocol) of the run's evaluation
    weights."""
    exp = trainer.exp
    return evaluate.accuracy(exp, eval_params(trainer.state, exp),
                             trainer.device, n_batches)


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def time_us(fn: Callable, *args, reps: int = 3):
    """``(microseconds per call, last result)``; the first call is a
    warm-up and is not timed.  On the card by CUDA events around the
    ``reps`` calls, ending in a synchronize; on the CPU by the host's
    clock."""
    out = fn(*args)
    dev = next((a.device for a in args if torch.is_tensor(a)), None)
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    return (time.perf_counter() - t0) * 1e6 / reps, out


def one_per_kind(shapes):
    """The first ConvShape of each ``kind``: body, stride-2 transition and
    1x1 downsample (the fast-mode sweep subset)."""
    by_kind = {}
    for s in shapes:
        by_kind.setdefault(s.kind, s)
    return list(by_kind.values())


def energy_fields(trainer, steps: Optional[int] = None) -> str:
    """Derived-CSV fragment from the run's EnergyReport.

    ``paper_composition`` is the config-derived Table 3/4 cross-check;
    ``comp_saving_measured`` is the telemetry-driven column (empty when the
    run produced no measurement: absence, not zero).
    """
    rep = trainer.energy_report(steps=steps)
    meas = rep.computational_savings_measured
    return (f"paper_composition={rep.paper_composition:.4f};"
            f"comp_saving_assumed={rep.computational_savings_assumed:.4f};"
            f"comp_saving_measured="
            + ("" if meas is None else f"{meas:.4f}")
            + f";energy_saving_45nm={rep.energy_savings_assumed:.4f}")
