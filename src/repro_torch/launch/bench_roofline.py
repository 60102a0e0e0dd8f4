"""The roofline bench (the JAX package's ``benchmarks/roofline.py``): the
per-(arch x shape x mesh) roofline table of the dry-run artifact
(``dryrun_results.json`` at the repo's root, written by ``python -m
repro_torch.launch.dryrun --all --both-meshes --out dryrun_results.json``),
and an analytic one-card table for the paper's CNN backbones priced by
their per-layer cost tables (``tasks.cost_model``: never transformer math
for a CNN).

For each cell: the compute, memory and collective terms in seconds on the
H100 (``core/energy.H100_SXM``, the dry run's pricing), the bottleneck,
MODEL_FLOPS (6ND / 6 N_active D), the useful-compute ratio, and a one-line
"what would move the dominant term".
"""
from __future__ import annotations

import json
import os
from typing import List

SUGGEST = {
    "compute": "increase arithmetic intensity (fuse, larger microbatch) or "
               "drop compute via SLU/PSG int paths",
    "memory": "keep activations sharded (SP), bf16 residuals, fewer "
              "stacked-residual bytes per unit (deeper remat)",
    "collective": "overlap FSDP all-gathers with compute (prefetch next "
                  "unit), PSG 1-bit majority-vote all-reduce, reduce "
                  "resharding between blocks",
}

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def render(results_path: str = "dryrun_results.json") -> List[str]:
    if not os.path.exists(results_path):
        return [f"roofline: missing {results_path} — run "
                f"python -m repro_torch.launch.dryrun --all --both-meshes "
                f"--out {results_path}"]
    with open(results_path) as f:
        cells = json.load(f)
    rows = []
    for c in cells:
        mesh = "2x16x16" if c.get("multi_pod") else "16x16"
        tag = f"{c['arch']}/{c['shape']}/{mesh}"
        if c["status"] == "skipped":
            rows.append(f"roofline/{tag},0.0,SKIPPED:{c['reason'][:60]}")
            continue
        if c["status"] != "ok":
            rows.append(f"roofline/{tag},0.0,ERROR:{c['error'][:60]}")
            continue
        r = c["roofline"]
        useful = c["useful_ratio"]
        peak_gib = c["bytes_per_device"]["peak"] / 2**30
        rows.append(
            f"roofline/{tag},{r['step_s']*1e6:.1f},"
            f"compute_s={r['compute_s']:.2e};memory_s={r['memory_s']:.2e};"
            f"collective_s={r['collective_s']:.2e};bound={r['bottleneck']};"
            f"model_flops={c['model_flops_6nd']:.3e};"
            f"useful_ratio={useful:.3f};peak_GiB={peak_gib:.2f};"
            f"fix={SUGGEST[r['bottleneck']][:48]}")
    return rows


def render_cnn_analytic() -> List[str]:
    """One-card roofline of the paper's backbones from their cost tables
    (a CNN step fits one card: no dry-run artifact needed)."""
    from repro_torch.configs import paper_cnns
    from repro_torch.core.cost import BYTES_FP32
    from repro_torch.core.energy import roofline_terms
    from repro_torch.tasks import cost_model

    rows = []
    for factory in (paper_cnns.resnet74, paper_cnns.resnet110,
                    paper_cnns.mobilenetv2):
        exp = factory()
        cost = cost_model(exp)
        B = exp.train.global_batch
        flops = 2.0 * cost.train_macs(B)
        hbm_bytes = BYTES_FP32 * cost.moved_words(B)
        r = roofline_terms(flops, hbm_bytes, coll_bytes=0.0, chips=1)
        rows.append(
            f"roofline/{cost.name}/train_cifar/1chip,{r['step_s']*1e6:.1f},"
            f"compute_s={r['compute_s']:.2e};memory_s={r['memory_s']:.2e};"
            f"bound={r['bottleneck']};macs={cost.fwd_macs():.3e};"
            f"params={cost.param_count()};"
            f"fix={SUGGEST[r['bottleneck']][:48]}")
    return rows


def run(fast: bool = True, device=None) -> List[str]:
    """The bench driver's rows (``bench_run --only roofline``); it prices
    records, and runs nothing on ``device``."""
    return render(os.path.join(ROOT, "dryrun_results.json")) + \
        render_cnn_analytic()
