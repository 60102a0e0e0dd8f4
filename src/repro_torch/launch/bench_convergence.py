"""Paper Fig. 5: convergence (loss) against cumulative energy for SMB, SLU,
SLU + SMD and E2-Train (the JAX package's ``benchmarks/bench_convergence.py``,
with its rows and fields).

Rows ``fig5/{smb,slu,slu_smd,e2train}``; ``us_per_call`` is microseconds
per executed step.  ``energy_per_step`` is the per-executed-step energy
factor of the x-axis, from the run's EnergyReport: the measured SLU skip
and the measured PSG fallback's 45nm factor, the assumed factor only where
nothing was measured.  ``curve`` is every ``len(history) // 8``-th loss.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.config import E2TrainConfig, SLUConfig, SMDConfig
from repro_torch.launch.bench_common import csv_row, final_loss, run_lm

VARIANTS = {
    "smb": (E2TrainConfig(), dict()),
    "slu": (E2TrainConfig(slu=SLUConfig(True, alpha=1e-3)), dict()),
    "slu_smd": (E2TrainConfig(smd=SMDConfig(True),
                              slu=SLUConfig(True, alpha=1e-3)), dict()),
    "e2train": (E2TrainConfig.full(), dict(lr=0.03, optimizer="psg")),
}


def run(fast: bool = True, device=None, steps: Optional[int] = None
        ) -> List[str]:
    steps = steps or (60 if fast else 240)
    rows = []
    for tag, (e2, kw) in VARIANTS.items():
        hist, tr, wall = run_lm(e2, steps, device=device, **kw)
        rep = tr.energy_report(steps=steps)
        f = 1.0
        if e2.slu.enabled and rep.slu.resolved() is not None:
            f *= 1.0 - rep.slu.resolved()
        if e2.psg.enabled:
            f *= (rep.psg_factor_measured
                  if rep.psg_factor_measured is not None
                  else rep.psg_factor_assumed)
        curve = [round(h["loss"], 3) for h in hist[:: max(len(hist) // 8, 1)]]
        rows.append(csv_row(
            f"fig5/{tag}", wall / max(len(hist), 1) * 1e6,
            f"final={final_loss(hist):.4f};energy_per_step={f:.3f};"
            f"curve={'|'.join(map(str, curve))}"))
    return rows
