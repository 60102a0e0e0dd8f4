"""The static cost-audit record (``bench_run --json-audit`` / ``--only
audit``): the JAX package's ``benchmarks/bench_audit.py``.

No training and no timing: the record reconciles the three static views
of the port's cost story (``analysis/``) —

* the config-derived cost tables (``core/cost.py``),
* the op counter's per-group counts over the predict programs
  (``analysis/op_cost.py``),
* the lowered program's totals (``launch/export_cost.py``; for ResNet-74
  and the smoke LM only, :data:`EXPORT_WITNESS`: ``torch.export`` takes
  tens of seconds a CNN),

for the paper's CIFAR backbones and the smoke LM, and runs the lint
battery: the kernel lint (on the card), the repository linter, the
precision lint (on the CPU, where it runs the plain versions and the
train steps) and the hot-loop lint.

Schema (``schema_version`` 2, the reference's): every lint section is
``{"findings": [...], "passed": bool, "error": null | str}``; a linter that
*crashes* records its exception in ``error``, lands in ``lint_errors`` and
fails the record.  A section that cannot be checked on the device given
(the kernel lint on the CPU) says ``passed: null`` and lists its rules in
``unchecked``; so does the hot-loop lint's ``no-host-callback`` there.
``all_passed`` is ``false`` on any failure, else ``null`` when something
was not checked, else ``true``.
"""
from __future__ import annotations

import traceback
from typing import Callable, Iterable, List

SCHEMA_VERSION = 2
AUDIT_BATCH = 4
EXPORT_WITNESS = ("resnet74", "llama3-8b")     # models with the export column


def _experiments():
    from repro_torch.configs import smoke_experiment
    from repro_torch.configs.paper_cnns import (mobilenetv2, resnet74,
                                                resnet110)

    return [resnet74(), resnet110(), mobilenetv2(),
            smoke_experiment("llama3_8b")]


def _lint_section(run: Callable[[], dict]) -> dict:
    """Run one lint pass, capturing a crash as ``error`` (not a failure)."""
    try:
        section = dict(run())
        section.setdefault("error", None)
        return section
    except Exception as e:  # noqa: BLE001 — the point is to record it
        return {"findings": None, "passed": False,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc(limit=8)}


def lint_sections(device) -> dict:
    from repro_torch.analysis.hotloop_lint import hotloop_report
    from repro_torch.analysis.kernel_lint import RULES, kernel_lint_report
    from repro_torch.analysis.precision_lint import precision_report
    from repro_torch.analysis.repo_lint import repo_report

    def kernel_section():
        if device.type != "cuda":
            return {"findings": [], "passed": None,
                    "unchecked": list(RULES),
                    "reason": "the kernel lint runs on the card only"}
        return kernel_lint_report(device)

    return {
        "kernel_lint": _lint_section(kernel_section),
        "repo_lint": _lint_section(repo_report),
        "precision": _lint_section(lambda: precision_report(device="cpu")),
        "hotloop": _lint_section(lambda: hotloop_report(device=device)),
    }


def _all_passed(audits, sections, lint_errors):
    verdicts = [a["passed"] for a in audits] + \
        [s["passed"] for s in sections.values()]
    if lint_errors or any(v is False for v in verdicts):
        return False
    return None if any(v is None for v in verdicts) else True


def audit_json(fast: bool = True, device=None) -> dict:
    """The record: the four audits and the four lint sections."""
    from repro_torch.analysis.audit import audit_experiment
    from repro_torch.core.device import resolve_device

    dev = resolve_device(device)
    audits = [audit_experiment(exp, batch=AUDIT_BATCH, device=dev,
                               with_hlo=exp.model.name in EXPORT_WITNESS
                               ).to_dict() for exp in _experiments()]
    sections = lint_sections(dev)
    lint_errors = [name for name, s in sections.items() if s.get("error")]
    return {"schema_version": SCHEMA_VERSION, "device": dev.type,
            "audits": audits, **sections, "lint_errors": lint_errors,
            "all_passed": _all_passed(audits, sections, lint_errors)}


def run(fast: bool = True, device=None) -> Iterable[str]:
    """CSV rows (pass/fail in the derived column), one per audit and per
    lint section, then ``audit_all``; raises after them when the record
    failed."""
    record = audit_json(fast, device)
    rows: List[str] = []
    for a in record["audits"]:
        rel = "none" if a["hlo_rel_diff"] is None \
            else f"{a['hlo_rel_diff']:.4f}"
        rows.append(f"audit_{a['model']},0.0,"
                    f"{'pass' if a['passed'] else 'FAIL'}:hlo_rel={rel}")
    for name in ("kernel_lint", "repo_lint", "precision", "hotloop"):
        s = record[name]
        if s.get("error"):
            rows.append(f"{name},0.0,ERROR:{s['error']}")
        elif s["passed"] is None and not s["findings"]:
            rows.append(f"{name},0.0,not_checked:"
                        f"{'+'.join(s.get('unchecked', []))}")
        else:
            n = len(s["findings"])
            rows.append(f"{name},0.0,{'pass' if n == 0 else f'FAIL:{n}'}")
    rows.append(f"audit_all,0.0,all_passed={record['all_passed']}")
    yield from rows
    if record["all_passed"] is False:
        raise RuntimeError("the static cost audit failed: "
                           + "; ".join(r for r in rows if "FAIL" in r
                                       or "ERROR" in r))
