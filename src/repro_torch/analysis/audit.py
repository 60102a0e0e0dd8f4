"""Three-way cost reconciliation: the cost table against the counted ops
and the lowered program.

The counterpart of the JAX package's ``analysis/audit.py``.  The energy
claims rest on ``core/cost.py``'s hand-written tables.  This module checks
them against two independent witnesses of the same predict program:

* **ops** — :mod:`repro_torch.analysis.op_cost` runs the predict program
  under a dispatch mode and attributes MACs to the ``cost_scope`` groups
  the models declare.  Compared *per layer group* against the table.
* **lowered program** — ``launch/export_cost.analyze`` re-derives FLOP
  totals from the core-ATen graph ``torch.export`` lowers the program to.
  It carries no layer attribution, so this column reconciles at the
  *totals* level only.

The record keeps the reference's keys, so the two packages' audit
records compare key for key: ``jaxpr_total_macs``, ``jaxpr_total_flops``
and ``jaxpr_unknown_trips`` hold the op counter's totals (MACs and FLOPs
an example; a program that ran has no unknown trip), ``hlo_total_flops``,
``hlo_rel_diff`` and ``hlo_unknown_trips`` the lowered program's (FLOPs of
the whole batch, as the reference's compiled-HLO column).

Semantics (the reference's, unchanged):

* ``None`` ≠ 0 everywhere.  A group priced by only one witness gets
  ``None`` in the other column and **fails**.  A group both witnesses
  price at zero passes trivially.
* Tolerance is declared per audit: 1% for the CIFAR backbones (the table
  and the ops count the same convolutions), 5% for the LM (its table is
  the analytic ``core/energy.block_fwd_flops``).
* An unknown trip count poisons the lowered column: the audit fails rather
  than reconcile against a guess.

Per-group MAC witnesses: conv/fc/block/head/embed table kinds reconcile
against ``dot_macs + conv_macs``; the MobileNetV2 depthwise kind (nine
explicit multiplies in ``models/resnet.Depthwise``) against ``mul_flops``;
``bn`` layers carry no contraction and are excluded.

The programs run on the card unless the caller passes ``device="cpu"``;
the counts are shape-derived, so the two devices' groups agree bit for
bit.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tasks
from repro_torch.analysis.op_cost import ProgramCosts, op_costs
from repro_torch.core.config import Experiment
from repro_torch.core.cost import TableCostModel
from repro_torch.core.device import resolve_device

# MAC-bearing table kinds and which op counter witnesses them
_DOT_KINDS = ("conv", "fc", "block", "head", "embed")
_MUL_KINDS = ("dw",)

# declared per-task tolerances: the CNN tables count the very convolutions
# the program runs; the LM table is analytic
TOL_BY_TASK = {"cifar_cnn": 0.01, "lm": 0.05}
# the lowered program counts the comparisons and selects the op counter
# books as free; the reference's bound on its compiled HLO
HLO_TOL = 0.03

_RESNET_LAYER = re.compile(r"^s(\d+)b(\d+)\.")
_MBV2_LAYER = re.compile(r"^b(\d+)\.")
_LM_BLOCK = re.compile(r"^block\d+\.")


@dataclass(frozen=True)
class LayerRow:
    """One layer group's two-way table-against-ops reconciliation.

    ``None`` means that witness prices nothing MAC-bearing for the group —
    which is a failure when the other witness does (None ≠ 0).
    """

    group: str
    cost_macs: Optional[float]
    jaxpr_macs: Optional[float]
    abs_diff: Optional[float]
    rel_diff: Optional[float]
    ok: bool

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class AuditReport:
    """Per-layer + totals verdict for one experiment's predict program."""

    model: str
    task: str
    batch: int
    seq_len: Optional[int]
    tolerance: float
    hlo_tolerance: float
    rows: Tuple[LayerRow, ...]
    cost_total_macs: float
    jaxpr_total_macs: float
    jaxpr_total_flops: float
    jaxpr_unknown_trips: int
    hlo_total_flops: Optional[float]        # None = lowered column not run
    hlo_rel_diff: Optional[float]
    hlo_unknown_trips: Optional[float]
    passed: bool

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["rows"] = [r.to_dict() for r in self.rows]
        return d

    def failures(self) -> Tuple[str, ...]:
        out = [f"layer {r.group}: cost={r.cost_macs} ops={r.jaxpr_macs} "
               f"rel={r.rel_diff}" for r in self.rows if not r.ok]
        if self.jaxpr_unknown_trips:
            out.append(f"ops: {self.jaxpr_unknown_trips} unknown-trip "
                       "loop(s)")
        if self.hlo_unknown_trips:
            out.append(f"lowered: {self.hlo_unknown_trips:.0f} unknown-trip "
                       "while loop(s) — totals untrustworthy")
        if self.hlo_rel_diff is not None and \
                self.hlo_rel_diff > self.hlo_tolerance:
            out.append(f"lowered totals: rel={self.hlo_rel_diff:.4f} > "
                       f"{self.hlo_tolerance}")
        return tuple(out)

    def summary(self) -> str:
        lines = [f"cost audit: {self.model} ({self.task}) batch={self.batch}"
                 f" tol={self.tolerance:.0%}"
                 f" -> {'PASS' if self.passed else 'FAIL'}"]
        for r in self.rows:
            fmt = lambda v: "—" if v is None else f"{v:,.0f}"
            rel = "—" if r.rel_diff is None else f"{r.rel_diff:.4%}"
            lines.append(f"  {'ok' if r.ok else 'XX'} {r.group:<12}"
                         f" cost={fmt(r.cost_macs):>16} ops="
                         f"{fmt(r.jaxpr_macs):>16} rel={rel}")
        low = ("—" if self.hlo_total_flops is None
               else f"{self.hlo_total_flops:,.0f}"
                    f" (rel={self.hlo_rel_diff:.4%})")
        lines.append(f"  totals: cost_macs={self.cost_total_macs:,.0f}"
                     f" ops_macs={self.jaxpr_total_macs:,.0f}"
                     f" lowered_flops={low}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# layer-name -> scope-group mapping (inverse of the models' cost scopes)
# ---------------------------------------------------------------------------


def _group_of(layer_name: str, task: str) -> str:
    """The ``cost_scope`` group a cost-table layer's compute lands in.

    Mirrors the scopes of ``models/resnet.py`` / ``models/transformer.py``:
    a ResNet stage's block 0 is ``s{i}.trans`` and its other blocks
    ``s{i}.rest``, MobileNetV2's depthwise is its own group inside
    ``b{i}``, and the LM's blocks all run inside the one ``unit`` scope.
    """
    if task == "lm":
        if _LM_BLOCK.match(layer_name):
            return "unit"
        return layer_name                       # embed / head
    m = _RESNET_LAYER.match(layer_name)
    if m:
        return (f"s{m.group(1)}.trans" if int(m.group(2)) == 0
                else f"s{m.group(1)}.rest")
    m = _MBV2_LAYER.match(layer_name)
    if m:
        return layer_name if layer_name.endswith(".dw") else f"b{m.group(1)}"
    if layer_name in ("stem_bn",):
        return "stem"
    if layer_name in ("head_bn",):
        return "head"
    return layer_name                           # stem / head / fc


def _table_group_macs(cost: TableCostModel, task: str
                      ) -> Dict[str, Tuple[float, str]]:
    """group -> (MAC total, witness kind: 'dot'|'mul') over MAC-bearing
    layers.  bn layers are excluded (no contraction to witness)."""
    groups: Dict[str, Tuple[float, str]] = {}
    for layer in cost.layers:
        if layer.kind in _MUL_KINDS:
            witness = "mul"
        elif layer.kind in _DOT_KINDS:
            witness = "dot"
        else:
            continue
        g = _group_of(layer.name, task)
        macs, w = groups.get(g, (0.0, witness))
        groups[g] = (macs + layer.macs, w)
    return groups


def _trace_group_macs(pc: ProgramCosts, witness_of: Dict[str, str],
                      batch: int) -> Dict[str, float]:
    """group -> MACs an example from the counted ops.  Groups the table
    doesn't know get the dot witness (so stray compute still surfaces)."""
    out: Dict[str, float] = {}
    for scope, c in pc.by_scope.items():
        w = witness_of.get(scope, "dot")
        macs = c.mul_flops if w == "mul" else c.macs()
        if macs > 0 or scope in witness_of:
            out[scope] = macs / batch
    return out


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------


def predict_program(exp: Experiment, batch: int, device: torch.device):
    """``(fn, model, input)`` with ``fn(model, input)`` the task's predict
    program on a ``batch`` of zeros: random weights from seed 0 (the counts
    depend on the shapes alone)."""
    task = tasks.get_task(exp.task)
    model = task.init(exp, 0, device)
    predict = task.make_predict(exp)
    if exp.task == "lm":
        x = torch.zeros((batch, exp.train.seq_len), dtype=torch.long,
                        device=device)
        return (lambda m, t: predict(m, {"tokens": t})), model, x
    x = torch.zeros((batch, 32, 32, 3), device=device)
    return (lambda m, t: predict(m, {"image": t})), model, x


_REPORTS: Dict[tuple, AuditReport] = {}


def audit_experiment(exp: Experiment, batch: int = 8,
                     tolerance: Optional[float] = None,
                     with_hlo: bool = True, device=None,
                     cost: Optional[TableCostModel] = None) -> AuditReport:
    """Reconcile one experiment's cost table (``cost``, default the task's)
    against its counted predict program (per layer group) and its lowered
    program (totals), on ``device`` (default the card; raises without
    one).  Reports are cached per configuration, table and device type:
    the counts depend on nothing else."""
    dev = resolve_device(device)
    tol = TOL_BY_TASK.get(exp.task, 0.05) if tolerance is None else tolerance
    cost = tasks.cost_model(exp) if cost is None else cost
    key = (exp.model, exp.task, exp.train.seq_len, batch, tol, with_hlo,
           dev.type, cost)
    if key in _REPORTS:
        return _REPORTS[key]
    fn, model, x = predict_program(exp, batch, dev)
    pc = op_costs(fn, model, x)

    table = _table_group_macs(cost, exp.task)
    witness_of = {g: w for g, (_, w) in table.items()}
    trace = _trace_group_macs(pc, witness_of, batch)

    rows = []
    for g in sorted(set(table) | set(trace)):
        cm = table.get(g, (None,))[0]
        jm = trace.get(g)
        if cm is None or jm is None:
            both_zero = (cm in (None, 0.0)) and (jm in (None, 0.0))
            rows.append(LayerRow(g, cm, jm, None, None, ok=both_zero))
            continue
        abs_d = abs(cm - jm)
        denom = max(cm, jm)
        rel = abs_d / denom if denom else 0.0
        rows.append(LayerRow(g, cm, jm, abs_d, rel, ok=rel <= tol))

    tot = pc.total()
    ops_macs = sum(v for v in trace.values())
    cost_macs = sum(m for m, _ in table.values())

    low_flops = low_rel = low_unknown = None
    if with_hlo:
        from repro_torch.launch import export_cost
        totals = export_cost.analyze(fn, (model,), (x,))
        low_flops = totals["flops"]
        low_unknown = totals["unknown_trip_count"]
        denom = max(low_flops, tot.flops())
        low_rel = abs(low_flops - tot.flops()) / denom if denom else 0.0

    passed = all(r.ok for r in rows) and pc.unknown_trips == 0
    if with_hlo:
        passed = passed and not low_unknown and low_rel <= HLO_TOL

    rep = AuditReport(
        model=exp.model.name, task=exp.task, batch=batch,
        seq_len=exp.train.seq_len if exp.task == "lm" else None,
        tolerance=tol, hlo_tolerance=HLO_TOL, rows=tuple(rows),
        cost_total_macs=cost_macs, jaxpr_total_macs=ops_macs,
        jaxpr_total_flops=tot.flops() / batch,
        jaxpr_unknown_trips=pc.unknown_trips,
        hlo_total_flops=low_flops, hlo_rel_diff=low_rel,
        hlo_unknown_trips=low_unknown, passed=passed)
    _REPORTS[key] = rep
    return rep


def audit_totals(exp: Experiment, batch: int = 8, with_hlo: bool = True,
                 device=None) -> Dict[str, Any]:
    """Totals-level view of :func:`audit_experiment` (the bench record)."""
    rep = audit_experiment(exp, batch=batch, with_hlo=with_hlo,
                           device=device)
    return {"model": rep.model, "task": rep.task,
            "cost_total_macs": rep.cost_total_macs,
            "jaxpr_total_macs": rep.jaxpr_total_macs,
            "hlo_total_flops": rep.hlo_total_flops,
            "hlo_rel_diff": rep.hlo_rel_diff,
            "passed": rep.passed, "failures": list(rep.failures())}


def validated_verdict(exp: Experiment, batch: int = 4,
                      cost: Optional[TableCostModel] = None,
                      device=None) -> bool:
    """Pass/fail of the three-way audit of this experiment's architecture
    against ``cost`` (default the task's table), for
    ``EnergyReport.validated_against_hlo``.  PSG/SLU operating points do
    not change the predict program, and the report is cached
    (:func:`audit_experiment`), so the energy ledger never re-runs it."""
    return audit_experiment(exp, batch=batch, device=device,
                            cost=cost).passed
