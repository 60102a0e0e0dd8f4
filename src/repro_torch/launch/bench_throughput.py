"""Chunked-loop throughput: executed steps/s of the chunked loop against the
per-step loop (the JAX package's ``benchmarks/bench_throughput.py``, with
its configurations, record and rows).

The chunked loop (``training/loop.py``; on the card one captured CUDA graph
replayed K times a chunk) takes K executed steps per dispatch, prefetches
batches on a thread and syncs metrics once per chunk.  Two configurations
of the paper's depth-14 CIFAR ResNet, E2-Train off:

* ``resnet14_cifar``: paper-shaped (32 x 32 x 3, width 16, batch 8, K 8,
  48 measured steps);
* ``resnet14_overhead_bound``: the loop-overhead-bound shape (8 x 8 images,
  width 4, batch 2, K 32, 128 measured steps), where per-step dispatch and
  metric syncs are comparable to the step itself.

Each loop warms up over ``2K`` steps (build, capture) before ``steps`` are
timed on the host's clock, ending in a synchronize.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.configs.paper_cnns import cnn_model
from repro_torch.core.config import E2TrainConfig, Experiment, TrainConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import (GaussianImageTask, host_image_batch,
                                        make_image_batch)
from repro_torch.launch.bench_common import sync
from repro_torch.launch.train import _fp32_is_fp32
from repro_torch.training.train_step import init_train_state
from repro_torch.training.trainer import Trainer

CONFIGS = {
    # name: (hw, width, batch, chunk_steps, measure_steps)
    "resnet14_cifar": (32, 16, 8, 8, 48),
    "resnet14_overhead_bound": (8, 4, 2, 32, 128),
}


def _throughput(hw: int, width: int, batch: int, chunk_steps: int,
                steps: int, device=None) -> Dict[str, float]:
    dev = resolve_device(device)
    _fp32_is_fp32()
    task = GaussianImageTask(num_classes=10, snr=2.0, hw=hw)
    exp = Experiment(model=cnn_model("resnet14", 14, width=width),
                     e2=E2TrainConfig(),
                     train=TrainConfig(global_batch=batch, lr=0.03,
                                       optimizer="sgdm",
                                       total_steps=1_000_000,
                                       schedule="constant"),
                     task="cifar_cnn")
    out: Dict[str, float] = {"hw": hw, "width": width, "batch": batch,
                             "chunk_steps": chunk_steps, "steps": steps}
    for label, k in (("per_step", 1), ("chunked", chunk_steps)):
        tr = Trainer(exp, init_train_state(exp, seed=0, device=dev),
                     lambda s, sh: make_image_batch(task, 0, s, sh, batch,
                                                    dev),
                     device=dev, chunk_steps=k,
                     make_host_batch=lambda s, sh: host_image_batch(
                         task, 0, s, sh, batch, pin=dev.type == "cuda"))
        tr.run(2 * chunk_steps)              # build, capture, warm up
        n0 = tr.executed_steps
        sync(dev)
        t0 = time.perf_counter()
        tr.run(steps)
        sync(dev)
        wall = time.perf_counter() - t0
        out[f"{label}_steps_per_s"] = (tr.executed_steps - n0) / wall
    out["chunk_speedup"] = (out["chunked_steps_per_s"] /
                            out["per_step_steps_per_s"])
    return out


def throughput_json(fast: bool = True, device=None,
                    steps: Optional[int] = None) -> dict:
    """Every configuration's record (``steps`` replaces each one's measured
    steps; full mode doubles them)."""
    return {name: _throughput(hw, width, batch, k,
                              steps or (n if fast else 2 * n), device)
            for name, (hw, width, batch, k, n) in CONFIGS.items()}


def run(fast: bool = True, device=None, steps: Optional[int] = None
        ) -> List[str]:
    """CSV rows: microseconds per executed step of the chunked loop, and
    the speedup over the per-step loop."""
    rows = []
    for name, row in throughput_json(fast, device, steps).items():
        us = 1e6 / row["chunked_steps_per_s"]
        rows.append(f"throughput_{name},{us:.1f},"
                    f"speedup={row['chunk_speedup']:.2f}x_"
                    f"per_step={row['per_step_steps_per_s']:.1f}/s")
    return rows
