"""Paper Fig. 4: SLU (learned gates) against stochastic depth (random
skipping) (the JAX package's ``benchmarks/bench_slu.py``, with its rows and
fields).

Rows ``fig4/{slu_mild,slu_strong,sd_skip20,sd_skip40}``; ``us_per_call`` is
microseconds per nominal step.  The SLU rows' ``exec_ratio`` is ``1 -`` the
run's measured skip (``energy_report(steps).slu.measured``); the stochastic
depth rows give their keep probability.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.config import E2TrainConfig, SLUConfig
from repro_torch.launch.bench_common import (csv_row, eval_accuracy,
                                             final_loss, run_lm)


def _run_sd(keep_prob: float, steps: int, device):
    """Stochastic depth: SLU with a frozen random gate (``min_keep_prob``
    at the keep probability and ``alpha`` so large that the learned gate
    saturates at that floor, which is random skipping)."""
    e2 = E2TrainConfig(slu=SLUConfig(enabled=True, alpha=50.0,
                                     min_keep_prob=keep_prob,
                                     never_skip_first_last=False))
    return run_lm(e2, steps, alpha=50.0, device=device)


def run(fast: bool = True, device=None, steps: Optional[int] = None
        ) -> List[str]:
    steps = steps or (100 if fast else 400)
    rows = []
    for alpha, tag in ((1e-3, "slu_mild"), (0.05, "slu_strong")):
        e2 = E2TrainConfig(slu=SLUConfig(enabled=True, alpha=alpha,
                                         never_skip_first_last=False))
        hist, tr, wall = run_lm(e2, steps, device=device)
        # the measured whole-run gate execution, from the ledger (None != 0)
        skip = tr.energy_report(steps=steps).slu.measured
        exec_ratio = 1.0 - (skip or 0.0)
        rows.append(csv_row(
            f"fig4/{tag}", wall / steps * 1e6,
            f"loss={final_loss(hist):.4f};acc={eval_accuracy(tr):.4f};"
            f"exec_ratio={exec_ratio:.2f}"))
    for kp, tag in ((0.8, "sd_skip20"), (0.6, "sd_skip40")):
        hist, tr, wall = _run_sd(kp, steps, device)
        rows.append(csv_row(
            f"fig4/{tag}", wall / steps * 1e6,
            f"loss={final_loss(hist):.4f};acc={eval_accuracy(tr):.4f};"
            f"exec_ratio={kp:.2f}"))
    return rows
