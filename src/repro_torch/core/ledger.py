"""EnergyLedger: measured training telemetry → the paper's headline numbers.

The middle layer of the energy accounting (a copy of the JAX package's
``core/ledger.py``).  The trainer already
measures what actually executed — SMD executed/dropped step counts, per-step
SLU execution ratios, the MAC-weighted PSG fallback-tile ratio — and the
cost model (``core/cost.py``, resolved through ``repro_torch.tasks``) knows the
per-layer op counts.  The ledger composes the two with the 45nm per-op
tables (``core/energy.py``) into an :class:`EnergyReport` that always shows
**measured next to assumed**:

* *assumed* — the operating point the config declares (``smd.drop_prob`` ×
  ``smd.epochs_multiplier``, ``slu.target_skip``, the 0.4 PSG fallback
  design assumption);
* *measured* — what the telemetry says, ``None`` when no measurement exists
  (a baseline run has no PSG fallback measurement — that is not a
  measurement of zero).

The paper's Table 3/4 composition law
(``savings = 1 − smd_ratio · (1 − slu_skip) · psg_factor``) is carried as a
cross-check column (``paper_composition``, using the paper's implied
r = 0.368) so every report can be compared against the published rows
(80.27 / 85.20 / 90.13 % at skip 20/40/60%).

Entry point: ``Trainer.energy_report()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.core.config import Experiment
from repro_torch.core.cost import TableCostModel
from repro_torch.core.energy import (FP32_MAC_PJ, PSG_FACTOR_PAPER,
                               PSG_FALLBACK_ASSUMED, computational_savings,
                               measured_psg_factor, move_energy_pj,
                               psg_factor_from_energy_model, psg_mac_pj)


@dataclass(frozen=True)
class TechniqueEntry:
    """One technique's operating point, measured next to assumed.

    ``assumed`` is config-derived; ``measured`` comes from telemetry and is
    ``None`` when nothing was measured — ``None`` ≠ 0.
    """

    name: str
    enabled: bool
    assumed: Optional[float]
    measured: Optional[float]

    def resolved(self) -> Optional[float]:
        """Best available value: measured when present, else assumed."""
        return self.measured if self.measured is not None else self.assumed


@dataclass(frozen=True)
class EnergyReport:
    """The paper's accounting for one run/config, measured vs assumed.

    Ratios: ``smd`` is executed compute relative to the baseline step budget
    (``epochs_multiplier × (1 − drop_prob)``); ``slu`` is the skip ratio
    over gatable blocks; ``psg`` is the fallback-tile ratio.
    ``paper_composition`` applies the paper's own Table 3/4 law with its
    implied PSG factor r = 0.368 to the config-derived operating point —
    the cross-check against the published rows.  Energy columns integrate
    the 45nm per-op model over ``steps`` nominal training steps.
    """

    model: str
    task: str
    steps: int
    batch: int
    fwd_macs_per_example: float
    params: int
    gated_fraction: float
    smd: TechniqueEntry
    slu: TechniqueEntry
    psg: TechniqueEntry
    psg_factor_assumed: Optional[float]
    psg_factor_measured: Optional[float]
    computational_savings_assumed: float
    computational_savings_measured: Optional[float]
    paper_composition: float
    energy_pj_baseline: float
    energy_pj_assumed: float
    energy_pj_measured: Optional[float]
    energy_savings_assumed: float
    energy_savings_measured: Optional[float]
    # cost-table verdict of the static cost audit (analysis/audit.py):
    # None when no audit was run (None is not False)
    validated_against_hlo: Optional[bool] = None
    # straggler telemetry: steps force-dropped
    # because they exceeded the per-step deadline.  A subset of the SMD
    # dropped count (the measured smd ratio already reflects them); carried
    # separately so a report distinguishes "dropped by schedule" from
    # "dropped because the hardware straggled".
    straggler_dropped: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        """Human-readable measured-vs-assumed table."""
        def fmt(v, pct=False):
            if v is None:
                return "—"
            return f"{v:.2%}" if pct else f"{v:.4f}"

        lines = [
            f"energy report: {self.model} ({self.task}), "
            f"{self.fwd_macs_per_example/1e6:.1f}M MACs/example, "
            f"{self.params/1e6:.2f}M params, {self.steps} nominal steps",
            f"  {'technique':<12}{'assumed':>10}{'measured':>10}",
        ]
        for t in (self.smd, self.slu, self.psg):
            tag = t.name + ("" if t.enabled else " (off)")
            lines.append(f"  {tag:<12}{fmt(t.assumed):>10}{fmt(t.measured):>10}")
        lines += [
            f"  {'psg factor':<12}{fmt(self.psg_factor_assumed):>10}"
            f"{fmt(self.psg_factor_measured):>10}",
            f"  computational savings: assumed {fmt(self.computational_savings_assumed, True)}"
            f" | measured {fmt(self.computational_savings_measured, True)}"
            f" | paper composition {fmt(self.paper_composition, True)}",
            f"  45nm energy savings:   assumed {fmt(self.energy_savings_assumed, True)}"
            f" | measured {fmt(self.energy_savings_measured, True)}"
            f" (baseline {self.energy_pj_baseline:.3e} pJ)",
            f"  cost table validated vs jaxpr/HLO: "
            + ("—" if self.validated_against_hlo is None
               else "yes" if self.validated_against_hlo else "NO"),
        ]
        return "\n".join(lines)


class EnergyLedger:
    """Accumulates per-step telemetry and turns it into an EnergyReport.

    Feed it a trainer (:meth:`from_trainer`) or record manually:
    ``record_step(metrics)`` per executed step, and set ``dropped_steps``.
    A ledger with no recorded telemetry still reports —
    with every ``measured`` column ``None`` (config-derived accounting
    only), which is how the Table 3 sweep is produced without training.
    """

    def __init__(self, exp: Experiment, cost: Optional[TableCostModel] = None):
        if cost is None:
            from repro_torch.tasks import cost_model   # deferred: tasks imports core
            cost = cost_model(exp)
        self.exp = exp
        self.cost = cost
        self.executed_steps = 0
        self.dropped_steps = 0
        self.straggler_dropped = 0
        self._slu_exec: List[float] = []
        self._psg_fallback: List[float] = []

    # ----- recording -----

    def record_step(self, metrics: Dict[str, float]) -> None:
        self.executed_steps += 1
        if "slu_exec_ratio" in metrics:
            self._slu_exec.append(float(metrics["slu_exec_ratio"]))
        if "psg_fallback_ratio" in metrics:
            self._psg_fallback.append(float(metrics["psg_fallback_ratio"]))

    @classmethod
    def from_trainer(cls, trainer) -> "EnergyLedger":
        led = cls(trainer.exp)
        for h in trainer.history:
            led.record_step(h)
        # the trainer's counters are authoritative (drops leave no metrics)
        led.executed_steps = trainer.executed_steps
        led.dropped_steps = trainer.dropped_steps
        led.straggler_dropped = trainer.straggler_dropped_steps
        return led

    # ----- measured quantities (None = not measured, never 0) -----

    def measured_smd_ratio(self, steps: int) -> Optional[float]:
        """Executed compute relative to a ``steps``-step baseline budget —
        the run's *actual* SMD energy ratio, executed_steps / steps.

        This deliberately does NOT scale the measured keep rate by the
        config's ``epochs_multiplier``: the multiplier is a protocol
        *assumption*, and a run that attempted a different number of
        nominal steps than the declared protocol (e.g. a bench running 2x
        the baseline budget) must report what it actually executed.  For a
        partial-telemetry ledger, pass the attempted window as ``steps``.
        """
        if not self.exp.e2.smd.enabled or \
                self.executed_steps + self.dropped_steps == 0:
            return None
        return self.executed_steps / steps

    def measured_slu_skip(self) -> Optional[float]:
        if not self.exp.e2.slu.enabled or not self._slu_exec:
            return None
        return 1.0 - sum(self._slu_exec) / len(self._slu_exec)

    def measured_psg_fallback(self) -> Optional[float]:
        if not self._psg_fallback:
            return None
        return sum(self._psg_fallback) / len(self._psg_fallback)

    # ----- the report -----

    def report(self, steps: Optional[int] = None,
               validate_against_hlo: bool = False,
               device=None) -> EnergyReport:
        """Build the report over ``steps`` nominal steps (default: the
        config's ``total_steps``); with ``validate_against_hlo`` also run
        the static cost audit of this ledger's table on ``device`` (the
        card unless ``"cpu"``; cached per configuration and table) and
        stamp its verdict into ``EnergyReport.validated_against_hlo``."""
        verdict: Optional[bool] = None
        if validate_against_hlo:
            # deferred: analysis imports tasks imports core
            from repro_torch.analysis.audit import validated_verdict
            verdict = validated_verdict(self.exp, cost=self.cost,
                                        device=device)
        exp, cost = self.exp, self.cost
        e2, tc = exp.e2, exp.train
        steps = steps if steps is not None else tc.total_steps
        batch = tc.global_batch

        # SMD: compute executed relative to the baseline step budget.
        # assumed = the declared protocol (m x epochs at keep rate 1-p);
        # measured = what this run actually executed vs that budget.
        m = e2.smd.epochs_multiplier
        smd = TechniqueEntry(
            "smd", e2.smd.enabled,
            m * (1.0 - e2.smd.drop_prob) if e2.smd.enabled else None,
            self.measured_smd_ratio(steps))
        slu = TechniqueEntry(
            "slu", e2.slu.enabled,
            e2.slu.target_skip if e2.slu.enabled else None,
            self.measured_slu_skip())
        psg = TechniqueEntry(
            "psg", e2.psg.enabled,
            PSG_FALLBACK_ASSUMED if e2.psg.enabled else None,
            self.measured_psg_fallback())

        p = e2.psg
        bits = (p.bits_x, p.bits_g, p.bits_x_msb, p.bits_g_msb)
        factor_a = (psg_factor_from_energy_model(bits, PSG_FALLBACK_ASSUMED)
                    if p.enabled else None)
        factor_m = (measured_psg_factor(e2, psg.measured)
                    if psg.measured is not None else None)

        # --- composition law (paper Tables 3/4) on MAC counts ---
        smd_a = smd.assumed if smd.assumed is not None else 1.0
        skip_a = slu.assumed if slu.assumed is not None else 0.0
        comp_a = computational_savings(smd_a, skip_a,
                                       factor_a if factor_a is not None else 1.0)
        paper = computational_savings(
            smd_a, skip_a, PSG_FACTOR_PAPER if p.enabled else 1.0)

        measured_any = any(t.measured is not None for t in (smd, slu, psg))
        comp_m = None
        if measured_any:
            smd_r = smd.resolved() if smd.enabled else 1.0
            skip_r = slu.resolved() if slu.enabled else 0.0
            f_r = 1.0
            if p.enabled:
                f_r = factor_m if factor_m is not None else factor_a
            comp_m = computational_savings(smd_r, skip_r, f_r)

        # --- 45nm energy integration over the nominal step budget ---
        def step_energy(slu_exec: float, fallback: Optional[float]) -> float:
            if p.enabled:
                mac_pj = psg_mac_pj(p, PSG_FALLBACK_ASSUMED
                                    if fallback is None else fallback)
                move_bits = p.bits_x
            else:
                mac_pj, move_bits = FP32_MAC_PJ, 32
            return (cost.train_macs(batch, slu_exec) * mac_pj
                    + cost.moved_words(batch, slu_exec)
                    * move_energy_pj(move_bits))

        # baseline: every nominal step executed, full network, fp32
        baseline = steps * (cost.train_macs(batch) * FP32_MAC_PJ
                            + cost.moved_words(batch) * move_energy_pj(32))
        e_assumed = steps * smd_a * step_energy(1.0 - skip_a, None)
        e_measured = None
        if measured_any:
            smd_r = smd.resolved() if smd.enabled else 1.0
            skip_r = slu.resolved() if slu.enabled else 0.0
            e_measured = steps * smd_r * step_energy(
                1.0 - skip_r, psg.resolved() if p.enabled else None)

        return EnergyReport(
            model=exp.model.name, task=exp.task, steps=int(steps),
            batch=int(batch),
            fwd_macs_per_example=cost.fwd_macs(),
            params=cost.param_count(),
            gated_fraction=cost.gated_fraction(),
            smd=smd, slu=slu, psg=psg,
            psg_factor_assumed=factor_a, psg_factor_measured=factor_m,
            computational_savings_assumed=comp_a,
            computational_savings_measured=comp_m,
            paper_composition=paper,
            energy_pj_baseline=baseline,
            energy_pj_assumed=e_assumed,
            energy_pj_measured=e_measured,
            energy_savings_assumed=1.0 - e_assumed / baseline,
            energy_savings_measured=(
                None if e_measured is None else 1.0 - e_measured / baseline),
            straggler_dropped=int(self.straggler_dropped),
            validated_against_hlo=verdict)
