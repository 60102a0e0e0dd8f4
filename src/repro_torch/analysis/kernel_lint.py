"""Kernel lint: the JAX package's VMEM and BlockSpec rules, re-read for
Hopper and checked on the card.

The counterpart of the JAX package's ``analysis/kernel_lint.py``, which
traces each Pallas kernel and checks its grid mapping.  A CUDA kernel has
no grid mapping to read, so this lint runs every kernel of
``kernels/dispatch.shipped_kernels`` at its lint geometries on the card,
with each library noting its launches (``csrc/lint.cuh``: the
``__global__`` function, its block size and dynamic shared memory), and
reads back each noted kernel's attributes (``cudaFuncGetAttributes``) and
resident blocks an SM at that launch (``cudaOccupancyMaxActiveBlocks
PerMultiprocessor``).  The rules:

* ``smem-budget`` (the reference's ``vmem-budget``) — static plus dynamic
  shared memory fits the 232,448 bytes a block may opt into, and the
  dynamic part is no more than the kernel opted into
  (``cudaFuncAttributeMaxDynamicSharedMemorySize``);
* ``register-spill`` — no local memory (``localSizeBytes == 0``), unless
  :data:`ALLOWLIST` justifies it;
* ``occupancy`` — at least one block an SM at the launch's configuration
  (a launch that cannot be resident never runs);
* ``coverage`` (the reference's index-map coverage) — with the outputs'
  memory first filled with a sentinel (PyTorch's deterministic mode fills
  ``torch.empty`` with NaN, or an integer type's largest value), every
  output equals the plain version's within :data:`COVERAGE_REL` of its
  largest magnitude: a tile never written shows as a mismatch;
* ``acc-intent`` — every launch has a declared accumulator in
  ``dispatch.kernel_acc_dtypes``, and every shipped kernel launched.

The rules themselves (:func:`check_rows`, :func:`check_coverage`) are pure
functions of the recorded table, so the CPU tests check them on a table
recorded on the card.  The lint itself runs only there:
:func:`lint_shipped` raises on any other device, and no rule ever reports
a pass from the CPU.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.device import resolve_device

RULES = ("smem-budget", "register-spill", "occupancy", "coverage",
         "acc-intent")
SMEM_BLOCK_OPT_IN = 232_448     # bytes a block may opt into on an H100
# coverage checks that every output element was written; each kernel's own
# accuracy limit is chip_smoke.py's.  1e-2 of the largest magnitude passes
# kernel 9's rare code flips against its plain version and nothing the
# sentinel (NaN, or an integer type's largest value) leaves behind.
COVERAGE_REL = 1e-2
# __global__ function -> why its local memory is acceptable (the bf16
# flash kernels at hd 128, whose register caps are their design)
ALLOWLIST: Dict[str, str] = {
    "flash_fwd_mma_kernel":
        "__launch_bounds__(256, 2) caps a thread at 128 registers so that "
        "two blocks share an SM; the o accumulator and the score tile of "
        "hd 128 leave a few words to local memory, read once a key tile",
    "flash_bwd_dq_mma_kernel":
        "at hd 128 the dq accumulator, the S and dP tiles and the three "
        "bf16 parts of dS fill the 255 registers a thread may have; the "
        "spilled words are reloaded once a key tile",
    "flash_bwd_dkv_mma_kernel":
        "512 threads a block cap a thread at 128 registers (65,536 / 512); "
        "the int32 partials of the four code products at hd 128 leave a "
        "few words to local memory, flushed once a query tile",
}
# the library of each shipped kernel's base name
LIBRARY = {"conv_fwd": "conv", "conv_grad_x": "conv",
           "conv_grad_w_predictor": "conv", "conv_grad_w": "conv",
           "predictor_matmul": "psg_matmul", "psg_grad_w": "psg_matmul",
           "flash_fwd": "flash_attn", "flash_bwd_dq": "flash_attn",
           "flash_bwd_dkv": "flash_attn", "quantize": "quant",
           "slu_decide": "graph_cond"}


@dataclass(frozen=True)
class LintFinding:
    """One rule violation in one kernel."""

    kernel: str
    rule: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.kernel}: {self.message}"


def base_name(entry: str) -> str:
    return entry.split("[")[0]


def check_allowlist(allowlist: Dict[str, str]) -> None:
    """Every allowlist entry must carry a justification."""
    for name, why in allowlist.items():
        if not (isinstance(why, str) and why.strip()):
            raise ValueError(f"kernel-lint allowlist entry {name!r} has no "
                             "justification")


def check_rows(rows: List[Dict[str, Any]],
               intents: Optional[Dict[str, Dict[str, Tuple[str, ...]]]] = None,
               allowlist: Optional[Dict[str, str]] = None
               ) -> List[LintFinding]:
    """The resource rules over recorded launch rows (``kernel``,
    ``global`` and ``kernels/build.NOTE_FIELDS`` each)."""
    al = ALLOWLIST if allowlist is None else allowlist
    check_allowlist(al)
    if intents is None:
        from repro_torch.kernels.dispatch import kernel_acc_dtypes
        intents = kernel_acc_dtypes()
    out: List[LintFinding] = []
    for r in rows:
        where = f"{r['kernel']} ({r['global']}, {r['threads']} threads)"
        smem = r["static_smem"] + r["dynamic_smem"]
        if smem > SMEM_BLOCK_OPT_IN:
            out.append(LintFinding(where, "smem-budget",
                                   f"{smem} bytes of shared memory exceed "
                                   f"the {SMEM_BLOCK_OPT_IN} a block may "
                                   "opt into"))
        if r["dynamic_smem"] > r["max_dynamic_smem"]:
            out.append(LintFinding(where, "smem-budget",
                                   f"{r['dynamic_smem']} dynamic bytes past "
                                   f"the {r['max_dynamic_smem']} the kernel "
                                   "opted into"))
        if r["local_bytes"] > 0 and r["global"] not in al:
            out.append(LintFinding(where, "register-spill",
                                   f"{r['local_bytes']} bytes of local "
                                   f"memory a thread ({r['regs']} "
                                   "registers)"))
        if r["blocks_per_sm"] < 1:
            out.append(LintFinding(where, "occupancy",
                                   "no block can be resident on an SM at "
                                   "this launch configuration"))
        if r["global"] not in intents.get(base_name(r["kernel"]), {}):
            out.append(LintFinding(where, "acc-intent",
                                   "launch has no declared accumulator in "
                                   "dispatch.kernel_acc_dtypes"))
    return out


def check_coverage(coverage: List[Dict[str, Any]]) -> List[LintFinding]:
    """The coverage rule over recorded results (``kernel``, ``launches``,
    ``max_rel`` of each output, ``sentinel_fill``)."""
    out: List[LintFinding] = []
    for c in coverage:
        if not c["sentinel_fill"]:
            out.append(LintFinding(c["kernel"], "coverage",
                                   "outputs were not sentinel-filled: "
                                   "coverage not established"))
        if c["launches"] == 0:
            out.append(LintFinding(c["kernel"], "acc-intent",
                                   "the wrapper launched no kernel"))
        for i, rel in enumerate(c["max_rel"]):
            if not rel <= COVERAGE_REL:
                out.append(LintFinding(c["kernel"], "coverage",
                                       f"output {i} differs from the plain "
                                       f"version by {rel} of its largest "
                                       "magnitude (unwritten elements keep "
                                       "the sentinel)"))
    return out


@contextlib.contextmanager
def sentinel_outputs():
    """``torch.empty`` and its kin fill new memory with NaN (floats) or the
    largest integer (PyTorch's deterministic mode) inside."""
    import torch.utils.deterministic as det

    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = True
    try:
        yield
    finally:
        det.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


def _outputs(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float64 (inf where ``got``
    holds a NaN the plain version does not)."""
    g, w = got.double().cpu(), want.double().cpu()
    diff = (g - w).abs()
    diff = torch.where(torch.isnan(g) & ~torch.isnan(w),
                       torch.full_like(diff, float("inf")), diff)
    scale = float(w.abs().max()) if w.numel() else 0.0
    worst = float(diff.max()) if diff.numel() else 0.0
    return worst / scale if scale else worst


def lint_entry(name: str, fn, make_args, device: torch.device
               ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """One shipped kernel at its lint geometry on the card: its launch rows
    and its coverage result."""
    from repro_torch.kernels import build

    lib = LIBRARY[base_name(name)]
    args = make_args(device)
    want = _outputs(fn(*make_args(torch.device("cpu"))))
    torch.cuda.synchronize(device)
    with sentinel_outputs():
        probe = torch.empty(8, device=device)
        filled = bool(torch.isnan(probe).all())
        build.record_launches(lib, True)
        try:
            got = _outputs(fn(*args))
            torch.cuda.synchronize(device)
        finally:
            build.record_launches(lib, False)
    notes = build.launch_notes(lib)
    rows = [{"kernel": name, **n} for n in notes]
    cov = {"kernel": name, "launches": len(notes), "sentinel_fill": filled,
           "max_rel": [max_rel(g, w) for g, w in zip(got, want)]}
    return rows, cov


def lint_shipped(device=None) -> Tuple[List[LintFinding], Dict[str, Any]]:
    """Lint the whole shipped-kernel registry on the card: ``(findings,
    table)``, the table holding every launch row and coverage result.
    Raises off the card: a rule never passes on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the kernel lint reads the built kernels' "
                         "attributes and runs them: it runs on the card "
                         "only")
    from repro_torch.kernels.dispatch import shipped_kernels

    rows: List[Dict[str, Any]] = []
    coverage: List[Dict[str, Any]] = []
    for name, (fn, make_args) in shipped_kernels().items():
        r, c = lint_entry(name, fn, make_args, dev)
        rows += r
        coverage.append(c)
    findings = check_rows(rows) + check_coverage(coverage)
    return findings, {"rows": rows, "coverage": coverage}


def resources(rows: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Per kernel (base name), the most of each resource over its launches:
    registers a thread, static and dynamic shared memory, local bytes, and
    the fewest blocks an SM."""
    out: Dict[str, Dict[str, Any]] = {}
    for r in rows:
        k = out.setdefault(base_name(r["kernel"]), {
            "regs": 0, "static_smem": 0, "dynamic_smem": 0,
            "local_bytes": 0, "blocks_per_sm": None, "globals": []})
        for f in ("regs", "static_smem", "dynamic_smem", "local_bytes"):
            k[f] = max(k[f], r[f])
        b = k["blocks_per_sm"]
        k["blocks_per_sm"] = r["blocks_per_sm"] if b is None \
            else min(b, r["blocks_per_sm"])
        if r["global"] not in k["globals"]:
            k["globals"].append(r["global"])
    return out


def kernel_lint_report(device=None) -> Dict[str, Any]:
    """The bench record's ``kernel_lint`` section."""
    findings, table = lint_shipped(device)
    return {"findings": [str(f) for f in findings], "passed": not findings,
            "resources": resources(table["rows"])}
