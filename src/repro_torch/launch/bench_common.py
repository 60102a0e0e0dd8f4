"""The benchmarks' shared row format and energy fields (the JAX package's
``benchmarks/common.py``: ``csv_row`` and ``energy_fields``)."""
from __future__ import annotations

from typing import Optional


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


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
