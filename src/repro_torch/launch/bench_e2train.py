"""Paper Tab. 3: E2-Train (SMD + SLU + PSG) combined, savings and accuracy
(the JAX package's ``benchmarks/bench_e2train.py``, with its rows and
fields).

Each operating point is an ``E2TrainConfig``: SMD drop 0.5, SLU target skip
20/40/60% (alpha 2e-3 / 1e-2 / 4e-2, every block gated), PSG, trained with
the ``psg`` optimizer at lr 0.03.  The savings columns come from the run's
``energy_report()`` (the config-derived paper composition beside the
measured telemetry), with the published saving as ``paper=``.  Rows
``tab3/e2train_skip{20,40,60}``; ``us_per_call`` is microseconds per
executed step.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.config import (E2TrainConfig, PSGConfig, SLUConfig,
                                     SMDConfig)
from repro_torch.launch.bench_common import (csv_row, energy_fields,
                                             eval_accuracy, final_loss, run_lm)

# (target skip, SLU alpha, the paper's published saving)
POINTS = ((0.2, 2e-3, "0.8027"), (0.4, 1e-2, "0.8520"), (0.6, 4e-2, "0.9013"))


def operating_point(skip: float, alpha: float) -> E2TrainConfig:
    return E2TrainConfig(
        smd=SMDConfig(enabled=True, drop_prob=0.5),
        slu=SLUConfig(enabled=True, alpha=alpha, target_skip=skip,
                      never_skip_first_last=False),
        psg=PSGConfig(enabled=True))


def run(fast: bool = True, device=None, steps: Optional[int] = None
        ) -> List[str]:
    steps = steps or (160 if fast else 480)
    rows = []
    for skip, alpha, paper in POINTS:
        hist, tr, wall = run_lm(operating_point(skip, alpha), steps, lr=0.03,
                                optimizer="psg", device=device)
        rows.append(csv_row(
            f"tab3/e2train_skip{int(skip * 100)}",
            wall / max(tr.executed_steps, 1) * 1e6,
            f"loss={final_loss(hist):.4f};acc={eval_accuracy(tr):.4f};"
            f"{energy_fields(tr, steps=steps)};paper={paper}"))
    return rows
