"""Precision lint: narrow accumulators of narrow operands, caught by a run.

The counterpart of the JAX package's ``analysis/precision_lint.py``.  The
reference found by hand that its conv dx backward accumulated its k² tap
sums in ``gq.dtype``: bf16 cotangents silently collapsed.  This pass runs the
:mod:`repro_torch.analysis.dataflow` engine over every surface the port
ships and flags **any reduction whose accumulator is narrower than 32 bits
while its operands descend from narrow values**.

Lint surfaces (the reference's):

* the plain version of every ``dispatch.shipped_kernels()`` entry, run
  **twice** on the CPU: once at its registered operand dtypes and once
  with every shaped fp32 operand swapped to bf16.  The swap is the probe:
  an accumulator that follows the operand dtype (``torch.zeros(...,
  dtype=x.dtype)``, the dx backward's pattern) is invisible at fp32 and
  flagrant at bf16.  The CUDA kernels themselves are invisible to a
  dispatch mode; their accumulators are declared in
  ``dispatch.kernel_acc_dtypes`` and held there (the kernel lint checks
  each launch has an entry on the card);
* both CNN backbones' forward and backward train step, run on the CPU at a
  small batch (provenance does not depend on the batch);
* the declared intent: a shipped kernel with no ``kernel_acc_dtypes``
  entry, or a declared accumulator under 32 bits, is a finding.

``ALLOWLIST`` maps a site substring to a **non-empty justification**; an
empty one raises.  The surfaces run on the CPU: the linter raises unless
it is given ``device="cpu"``.  Run as a module (``python -m
repro_torch.analysis.precision_lint``) it exits nonzero on any finding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.dataflow import (DataflowResult, acc_is_narrow,
                                           analyze)
from repro_torch.core.device import resolve_device

# site-substring pattern -> justification.  Empty: every shipped surface
# accumulates in 32 bits or more.
ALLOWLIST: Dict[str, str] = {}
STEP_BATCH = 4          # images of the train-step surfaces


@dataclass(frozen=True)
class PrecisionFinding:
    surface: str        # which lint surface produced it
    rule: str           # "narrow-accumulator" | "acc-intent"
                        # | "acc-intent-missing"
    site: str
    kind: str
    acc_dtype: str
    narrow_operands: Tuple[str, ...]
    message: str

    def __str__(self) -> str:
        return (f"{self.surface}: [{self.rule}] {self.site} "
                f"({self.kind}, acc={self.acc_dtype}): {self.message}")


def check_allowlist(allowlist: Dict[str, str]) -> None:
    """Every allowlist entry must carry a non-empty justification."""
    for pattern, why in allowlist.items():
        if not (isinstance(why, str) and why.strip()):
            raise ValueError(
                f"precision allowlist entry {pattern!r} has no "
                "justification — record why the narrow accumulator is "
                "intentional")


def split_findings(findings: Sequence[PrecisionFinding],
                   allowlist: Optional[Dict[str, str]] = None
                   ) -> Tuple[List[PrecisionFinding], List[PrecisionFinding]]:
    """(unallowlisted, allowlisted) under a justified allowlist."""
    al = ALLOWLIST if allowlist is None else allowlist
    check_allowlist(al)
    out, suppressed = [], []
    for f in findings:
        (suppressed if any(p in f.site for p in al) else out).append(f)
    return out, suppressed


def hazard_findings(surface: str, result: DataflowResult
                    ) -> List[PrecisionFinding]:
    out = []
    for s in result.hazards():
        via = f" (narrow via {s.origin})" if s.origin else ""
        out.append(PrecisionFinding(
            surface=surface, rule="narrow-accumulator", site=s.site,
            kind=s.kind, acc_dtype=s.acc_dtype,
            narrow_operands=s.narrow_operands,
            message=f"accumulates {','.join(s.narrow_operands)}-descended "
                    f"operands in {s.acc_dtype}{via} — force a >=32-bit "
                    "accumulator (the dx backward's bug class)"))
    return out


def narrow_variant(args: tuple) -> tuple:
    """The operands with every shaped fp32 tensor swapped to bf16 — the
    probe that exposes dtype-following accumulators."""
    return tuple(a.to(torch.bfloat16)
                 if isinstance(a, torch.Tensor) and a.dtype == torch.float32
                 and a.dim() > 0 else a for a in args)


def _require_cpu(device) -> None:
    if resolve_device(device).type != "cpu":
        raise ValueError("the precision lint runs the plain versions and the "
                         "train steps on the CPU: pass device='cpu'")


def intent_findings(names, intents) -> List[PrecisionFinding]:
    """A shipped kernel with no declared accumulator, or a declared one
    under 32 bits."""
    out = []
    for base in sorted(names):
        if base not in intents:
            out.append(PrecisionFinding(
                surface=f"kernel:{base}", rule="acc-intent-missing",
                site=base, kind="registry", acc_dtype="?",
                narrow_operands=(),
                message="shipped kernel has no declared accumulator in "
                        "dispatch.kernel_acc_dtypes()"))
            continue
        for glob, dts in intents[base].items():
            for dt in dts:
                if acc_is_narrow(dt):
                    out.append(PrecisionFinding(
                        surface=f"kernel:{base}", rule="acc-intent",
                        site=f"{base}/{glob}", kind="registry",
                        acc_dtype=dt, narrow_operands=(),
                        message="declared accumulator under 32 bits"))
    return out


def lint_kernels(device=None, registry=None, intents=None
                 ) -> List[PrecisionFinding]:
    """Dataflow-lint the plain version of every shipped kernel (registered
    and bf16-narrowed) and check the declared intent."""
    _require_cpu(device)
    from repro_torch.kernels import dispatch

    registry = dispatch.shipped_kernels() if registry is None else registry
    intents = dispatch.kernel_acc_dtypes() if intents is None else intents
    findings = intent_findings({n.split("[")[0] for n in registry}, intents)
    cpu = torch.device("cpu")
    for name, (fn, make_args) in registry.items():
        args = make_args(cpu)
        for variant, a in (("", args), ("~bf16", narrow_variant(args))):
            surface = f"kernel:{name}{variant}"
            findings += hazard_findings(surface,
                                        analyze(fn, *a, name=surface))
    return findings


def lint_experiment(exp, batch: int = STEP_BATCH, device=None
                    ) -> List[PrecisionFinding]:
    """Dataflow-lint one CNN experiment's forward and backward train step
    on the CPU."""
    _require_cpu(device)
    from repro_torch.data.synthetic import (GaussianImageTask,
                                            make_image_batch)
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    state = init_train_state(exp, seed=0, device="cpu")
    data = make_image_batch(GaussianImageTask(num_classes=10), 0, 0, 0,
                            batch, "cpu")
    surface = f"train:{exp.model.name}"
    res = analyze(make_train_step(exp).step, state, data, name=surface)
    return hazard_findings(surface, res)


def _default_experiments():
    from repro_torch.configs.paper_cnns import mobilenetv2, resnet74
    return [resnet74(), mobilenetv2()]


def lint_all(exps=None, allowlist: Optional[Dict[str, str]] = None,
             device=None
             ) -> Tuple[List[PrecisionFinding], List[PrecisionFinding]]:
    """(unallowlisted, allowlisted) findings over every lint surface."""
    findings = lint_kernels(device)
    for exp in (exps if exps is not None else _default_experiments()):
        findings += lint_experiment(exp, device=device)
    return split_findings(findings, allowlist)


def precision_report(exps=None, device=None) -> dict:
    """The bench record's ``precision`` section."""
    findings, allowlisted = lint_all(exps, device=device)
    return {"findings": [str(f) for f in findings],
            "allowlisted": [str(f) for f in allowlisted],
            "passed": not findings}


def main() -> int:
    findings, allowlisted = lint_all(device="cpu")
    for f in findings:
        print(f)
    for f in allowlisted:
        print(f"allowlisted: {f}")
    print(f"precision lint: {len(findings)} finding(s), "
          f"{len(allowlisted)} allowlisted")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
