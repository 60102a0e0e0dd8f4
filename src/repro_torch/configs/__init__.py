"""Architecture configs: ``get_experiment(arch)`` returns the full
production config of a ported architecture; ``reduce_experiment`` cuts any
of them to toy dimensions for CPU tests (the JAX package's
``repro.configs``).  Ported: ``qwen2_5_3b`` and the paper's CNNs
(``paper_cnns``)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.core.config import Experiment

ARCH_IDS = ["qwen2_5_3b"]


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_experiment(arch: str) -> Experiment:
    name = canon(arch)
    if name not in ARCH_IDS:
        raise NotImplementedError(f"architecture {arch!r} is not ported; "
                                  f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").get_config()


def reduce_experiment(exp: Experiment) -> Experiment:
    """Same family and block structure, toy dimensions (a copy of the JAX
    package's generic reduction; its MoE/SSM/encoder cuts have no fields
    here)."""
    m = exp.model
    unit = m.block_unit or ()
    n_layers = max(len(unit), 2) if unit else 2
    heads = min(m.num_heads, 4)
    kv = max(1, min(m.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    small = dataclasses.replace(
        m,
        num_layers=n_layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64 // heads if m.head_dim == 0 else 16,
        d_ff=96 if m.d_ff else 0,
        vocab_size=128,
        sliding_window=min(m.sliding_window, 8) if m.sliding_window else 0,
        encoder_layers=min(m.encoder_layers, 2),
        frontend_tokens=8 if m.frontend else 0,
        dtype="float32",
    )
    tr = dataclasses.replace(exp.train, global_batch=2, seq_len=16,
                             total_steps=8, microbatches=1)
    return dataclasses.replace(exp, model=small, train=tr)
