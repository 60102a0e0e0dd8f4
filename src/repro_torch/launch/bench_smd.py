"""Paper Fig. 3a/3b and Tab. 1: SMD against SMB at matched energy budgets
(the JAX package's ``benchmarks/bench_smd.py``, with its rows and fields).

The paper's operating point (energy ratio 0.67) is derived from the SMD
config, ``expected_energy_ratio(drop 0.5, m = 4/3)``.  The SMD rows report
the ratio that executed, ``executed_steps / steps`` over the base budget
``steps`` (not the run's own ``2 steps ratio`` nominal steps), as the
reference does.  Nine rows: ``fig3a/smb@{r}`` and ``fig3a/smd@{r}`` for
``r`` in :data:`RATIOS`, and ``fig3b/smb_lr{0.1,0.14,0.2}``;
``us_per_call`` is microseconds per nominal step.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.config import E2TrainConfig, SMDConfig
from repro_torch.core.smd import expected_energy_ratio
from repro_torch.launch.bench_common import (csv_row, eval_accuracy,
                                             final_loss, run_lm)

SMD_CFG = SMDConfig(enabled=True, drop_prob=0.5)
# {1, 0.83, the paper's operating point}: the last is config-derived (0.67)
RATIOS = (1.0, 0.83, expected_energy_ratio(SMD_CFG))
LRS = (0.1, 0.14, 0.2)


def run(fast: bool = True, device=None, steps: Optional[int] = None
        ) -> List[str]:
    steps = steps or (100 if fast else 400)
    rows = []
    # SMB at the matched energy ratios: fewer iterations, the schedule
    # scaled (the paper's "off-the-shelf" option 1)
    for ratio in RATIOS:
        n = int(steps * ratio)
        hist, tr, wall = run_lm(E2TrainConfig(), n, total_steps=n,
                                device=device)
        rows.append(csv_row(
            f"fig3a/smb@{ratio:.2f}", wall / max(n, 1) * 1e6,
            f"loss={final_loss(hist):.4f};acc={eval_accuracy(tr):.4f};"
            f"energy_ratio={ratio:.2f}"))
    # SMD at the same executed budgets (2x nominal steps, p = 0.5)
    for ratio in RATIOS:
        n = int(2 * steps * ratio)
        hist, tr, wall = run_lm(E2TrainConfig(smd=SMD_CFG), n, total_steps=n,
                                device=device)
        executed_ratio = tr.executed_steps / max(steps, 1)
        rows.append(csv_row(
            f"fig3a/smd@{ratio:.2f}", wall / max(n, 1) * 1e6,
            f"loss={final_loss(hist):.4f};acc={eval_accuracy(tr):.4f};"
            f"energy_ratio={executed_ratio:.2f}"))
    # Fig. 3b: SMB with a larger lr at the SMD operating point's budget
    for lr in LRS:
        n = int(steps * expected_energy_ratio(SMD_CFG))
        hist, tr, wall = run_lm(E2TrainConfig(), n, lr=lr, total_steps=n,
                                device=device)
        rows.append(csv_row(
            f"fig3b/smb_lr{lr}", wall / max(n, 1) * 1e6,
            f"loss={final_loss(hist):.4f};acc={eval_accuracy(tr):.4f}"))
    return rows
