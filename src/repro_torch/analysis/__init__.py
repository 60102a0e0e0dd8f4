"""Static cost audit and linters of the port (the JAX package's
``repro.analysis``).

The energy story rests on three independent witnesses of the same
program:

* ``core/cost.py`` — the hand-written per-layer MAC tables (what the
  paper's arithmetic *assumes*);
* ``analysis/op_cost.py`` — the ops the predict program dispatches,
  counted under a dispatch mode and attributed to the models'
  ``cost_scope`` groups (what PyTorch actually runs);
* ``launch/export_cost.py`` — totals re-derived from the core-ATen graph
  ``torch.export`` lowers the program to (what a compiler is handed).

``analysis/audit.py`` three-way-diffs them into an :class:`AuditReport`
with a verdict under a declared tolerance; ``core/ledger.py`` stamps it
into ``EnergyReport.validated_against_hlo``.

``analysis/kernel_lint.py`` checks every CUDA kernel of
``kernels/dispatch.shipped_kernels`` on the card (shared memory, spills,
occupancy, output coverage, declared accumulators);
``analysis/repo_lint.py`` enforces the port's conventions (kernels built
and loaded only in ``kernels/``, one environment read, no host syncs
outside ``training/`` and ``launch/``, no swallowed exceptions).
``analysis/dataflow.py`` carries precision provenance through dispatched
ops, and ``analysis/precision_lint.py`` flags sub-32-bit accumulators of
narrow operands on the shipped plain versions and both CNN train steps;
``analysis/hotloop_lint.py`` checks the chunked loop's
``CHUNK_CONTRACT``.  ``launch/bench_audit.py`` records all of it.

The names that walk a jaxpr in the reference have their port's
counterparts here: ``op_costs`` (``jaxpr_costs``), ``current_scope``
(``scope_tag``), ``sub_graphs`` (``sub_jaxprs``), ``DataflowMode``
(``analyze_jaxpr``) and ``check_rows`` (``lint_jaxpr``).
"""
from repro_torch.analysis.audit import (AuditReport, LayerRow,
                                        audit_experiment, audit_totals)
from repro_torch.analysis.dataflow import (DataflowMode, DataflowResult,
                                           Prov, ReductionSite, analyze)
from repro_torch.analysis.hotloop_lint import (HotloopFinding,
                                               hotloop_report, lint_chunk)
from repro_torch.analysis.kernel_lint import (LintFinding, check_rows,
                                              lint_shipped)
from repro_torch.analysis.op_cost import OpCounts, ProgramCosts, op_costs
from repro_torch.analysis.precision_lint import (PrecisionFinding,
                                                 lint_kernels,
                                                 precision_report)
from repro_torch.analysis.repo_lint import lint_repo
from repro_torch.core.cost import current_scope
from repro_torch.launch.export_cost import sub_graphs

__all__ = [
    "AuditReport", "LayerRow", "audit_experiment", "audit_totals",
    "OpCounts", "ProgramCosts", "op_costs", "current_scope", "sub_graphs",
    "DataflowResult", "Prov", "ReductionSite", "analyze", "DataflowMode",
    "PrecisionFinding", "lint_kernels", "precision_report",
    "HotloopFinding", "lint_chunk", "hotloop_report",
    "LintFinding", "check_rows", "lint_shipped", "lint_repo",
]
