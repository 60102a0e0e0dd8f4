"""The benchmark driver: one module per paper table or figure (the JAX
package's ``benchmarks/run.py``).

    python -m repro_torch.launch.bench_run [--full] [--only a,b] [--device cpu]
    python -m repro_torch.launch.bench_run --json PATH [--json-throughput PATH]
    python -m repro_torch.launch.bench_run --json-ft [PATH] [--device cpu]
    python -m repro_torch.launch.bench_run --json-audit [PATH] [--device cpu]
    python -m repro_torch.launch.bench_run --json-conv PATH [--json-attn PATH]

Prints ``name,us_per_call,derived`` CSV.  ``--full`` runs the longer
budgets.  ``--only`` takes the benches with a port: ``smd`` (Fig. 3, Tab.
1), ``slu`` (Fig. 4), ``psg`` (Tab. 2), ``e2train`` (Tab. 3), ``cnn`` (Tab.
4), ``convergence`` (Fig. 5), ``kernels``, ``conv`` (the fused conv path
against im2col: bytes and device time, ``launch/bench_conv.py``), ``attn``
(the flash path against the materialized softmax, ``launch/bench_attn.py``),
``throughput``, ``ft`` (the fault-injection record), ``audit`` (the static
cost audit and the linters, ``launch/bench_audit.py``) and ``roofline``
(the dry run's roofline table and the CNNs' analytic one,
``launch/bench_roofline.py``; it runs nothing on a device, so it needs no
card).  Every bench of the JAX package's ``benchmarks/run.py`` has a port.

A bench that raises prints ``name,0.0,ERROR:<type>:<message>`` (its
traceback on stderr); the driver carries on with the others and exits 1 at
the end.

``--json PATH`` writes the energy record instead: the config-derived Table
3 sweep (ResNet-74 at SLU skip 0.2 / 0.4 / 0.6, no training) and a measured
E2-Train run (ResNet-14 at width 16 and batch 8, or ResNet-26 over 40 steps
with ``--full``), every field from ``EnergyReport.to_dict()``;
``validated_against_hlo`` is null (no cost audit ran).  ``--json-throughput
PATH`` writes the chunked loop's throughput record
(``bench_throughput.throughput_json``).  ``--json-ft [PATH]`` (default
``BENCH_ft.json``) writes the fault-injection record
(``bench_ft.ft_json``) and exits 1 when any scenario did not recover.
``--json-audit [PATH]`` (default ``BENCH_audit.json``) writes the static
cost-audit record (``bench_audit.audit_json``) and exits 1 when an audit
or a linter failed, 2 when a linter crashed.  ``--json-conv PATH`` and
``--json-attn PATH`` write the conv and attention records
(``bench_conv.conv_json``, ``bench_attn.attn_json``) and exit 1 when a
path's byte accounting is incomplete; they have no default path (the JAX
package's ``BENCH_conv.json`` and ``BENCH_attn.json`` at the repo root are
never written).  Each writes only to the path it is given.

Runs on the card unless ``--device cpu`` is given; the kernels build at the
first call that needs them, inside the first bench that runs them (build
them first, as ``chip_smoke.py`` does, to keep the build out of the rows).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Optional, Sequence

import torch

from repro_torch.configs.paper_cnns import cnn_model, resnet74
from repro_torch.core.config import (E2TrainConfig, Experiment, PSGConfig,
                                     SLUConfig, SMDConfig, TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.core.ledger import EnergyLedger
from repro_torch.data.synthetic import GaussianImageTask, make_image_batch
from repro_torch.launch import (bench_attn, bench_audit, bench_cnn,
                                bench_conv, bench_convergence, bench_e2train,
                                bench_ft, bench_kernels, bench_psg,
                                bench_roofline, bench_slu, bench_smd,
                                bench_throughput)
from repro_torch.launch.train import _fp32_is_fp32
from repro_torch.training.train_step import init_train_state
from repro_torch.training.trainer import Trainer

BENCHES = {
    "smd": bench_smd.run,                   # Fig. 3a/3b, Tab. 1
    "slu": bench_slu.run,                   # Fig. 4
    "psg": bench_psg.run,                   # Tab. 2
    "e2train": bench_e2train.run,           # Tab. 3
    "cnn": bench_cnn.run,                   # Tab. 4
    "convergence": bench_convergence.run,   # Fig. 5
    "kernels": bench_kernels.run,
    "conv": bench_conv.run,                 # implicit GEMM against im2col
    "attn": bench_attn.run,                 # flash against the (S, T) path
    "throughput": bench_throughput.run,     # the chunked loop
    "ft": bench_ft.run,                     # fault-injection recovery
    "audit": bench_audit.run,               # the static cost audit, linters
    "roofline": bench_roofline.run,         # dry-run records, priced
}
# benches that run nothing on a device
DEVICELESS = frozenset({"roofline"})


def table3_config_derived() -> list:
    """ResNet-74's energy reports at the paper's three operating points
    (SLU skip 0.2 / 0.4 / 0.6), from the config alone: every measured
    column is null (absent, not 0)."""
    table3 = []
    for skip in (0.2, 0.4, 0.6):
        op = E2TrainConfig(smd=SMDConfig(enabled=True, drop_prob=0.5),
                           slu=SLUConfig(enabled=True, target_skip=skip),
                           psg=PSGConfig(enabled=True))
        table3.append(EnergyLedger(resnet74(e2=op)).report().to_dict())
    return table3


def energy_json(fast: bool = True, device=None) -> dict:
    """The energy record: the Table 3 sweep derived from the config, and a
    short measured E2-Train run on the paper's ResNet through the
    trainer's ``energy_report``."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    table3 = table3_config_derived()
    depth, steps = (14, 12) if fast else (26, 40)
    e2 = E2TrainConfig(smd=SMDConfig(enabled=True, drop_prob=0.5),
                       slu=SLUConfig(enabled=True, alpha=5e-3,
                                     target_skip=0.2),
                       psg=PSGConfig(enabled=True, swa=False))
    exp = Experiment(model=cnn_model(f"resnet{depth}", depth), e2=e2,
                     train=TrainConfig(global_batch=8, lr=0.03,
                                       optimizer="psg", total_steps=steps,
                                       schedule="constant"),
                     task="cifar_cnn")
    task = GaussianImageTask(num_classes=10, snr=2.0)
    tr = Trainer(exp, init_train_state(exp, seed=0, device=dev),
                 lambda s, sh: make_image_batch(task, 0, s, sh, 8, dev),
                 device=dev)
    tr.run(steps)
    return {"table3_config_derived": table3,
            "measured_run": tr.energy_report(steps=steps).to_dict()}


def _write(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    print(f"wrote {path}", file=sys.stderr)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated bench names: "
                         + ",".join(BENCHES))
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises without a card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the energy record to PATH (skips the CSV "
                         "benches)")
    ap.add_argument("--json-throughput", default=None, metavar="PATH",
                    help="write the chunked loop's throughput record to "
                         "PATH (skips the CSV benches)")
    ap.add_argument("--json-ft", nargs="?", const="BENCH_ft.json",
                    default=None, metavar="PATH",
                    help="write the fault-injection recovery record "
                         "(corruption fallback, producer raise, write "
                         "retry and surfacing, kill and restart) to PATH "
                         "and exit 1 if any recovery failed (skips the CSV "
                         "benches)")
    ap.add_argument("--json-audit", nargs="?", const="BENCH_audit.json",
                    default=None, metavar="PATH",
                    help="write the static cost-audit record (cost tables "
                         "against the counted ops and the lowered program, "
                         "and the linters) to PATH; exit 1 when it failed, "
                         "2 when a linter crashed (skips the CSV benches)")
    ap.add_argument("--json-conv", default=None, metavar="PATH",
                    help="write the fused-conv record (implicit GEMM against "
                         "im2col: bytes per path and device time) to PATH; "
                         "exit 1 when a path's accounting is incomplete "
                         "(skips the CSV benches)")
    ap.add_argument("--json-attn", default=None, metavar="PATH",
                    help="write the flash-attention record (the PSG flash "
                         "path against the materialized softmax: bytes per "
                         "path and device time) to PATH; exit 1 when a "
                         "path's accounting is incomplete (skips the CSV "
                         "benches)")
    args = ap.parse_args(argv)
    fast = not args.full
    only = args.only.split(",") if args.only else list(BENCHES)
    for name in only:
        if name not in BENCHES:
            print(f"unknown bench {name!r}; expected one of "
                  f"{', '.join(BENCHES)}", file=sys.stderr)
            return 2
    records = args.json or args.json_throughput or args.json_ft or \
        args.json_audit or args.json_conv or args.json_attn
    dev = None if not records and set(only) <= DEVICELESS and \
        args.device is None else resolve_device(args.device)

    if records:
        if args.json:
            _write(args.json, energy_json(fast, dev))
        if args.json_throughput:
            _write(args.json_throughput,
                   bench_throughput.throughput_json(fast, dev))
        if args.json_ft:
            record = bench_ft.ft_json(fast, dev)
            _write(args.json_ft, record)
            if not record["all_recovered"]:
                print("fault-injection recovery FAILED", file=sys.stderr)
                return 1
        if args.json_audit:
            record = bench_audit.audit_json(fast, dev)
            _write(args.json_audit, record)
            if record["lint_errors"]:
                print("lint pass(es) crashed: "
                      f"{', '.join(record['lint_errors'])}", file=sys.stderr)
                return 2
            if record["all_passed"] is False:
                print("static cost audit FAILED", file=sys.stderr)
                return 1
        for path, bench, make in (
                (args.json_conv, bench_conv, bench_conv.conv_json),
                (args.json_attn, bench_attn, bench_attn.attn_json)):
            if not path:
                continue
            try:
                record = make(fast, dev)
            except bench.IncompleteAccountingError as e:
                print(f"byte accounting incomplete: {e}", file=sys.stderr)
                return 1
            _write(path, record)
        return 0

    where = "no device" if dev is None else \
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# benchmarks on {where}", file=sys.stderr)
    print("name,us_per_call,derived", flush=True)
    failed = []
    for name, fn in BENCHES.items():
        if name not in only:
            continue
        t0 = time.time()
        try:
            for row in fn(fast=fast, device=dev):
                print(row, flush=True)
        except Exception as e:  # a bench's failure is a row, then exit 1
            traceback.print_exc()
            print(f"{name},0.0,ERROR:{type(e).__name__}:{e}", flush=True)
            failed.append(name)
        print(f"# {name} done in {time.time() - t0:.1f}s", file=sys.stderr)
    if failed:
        print(f"failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
