"""Architecture configs: ``get_experiment(arch)`` returns the full
production config of a ported architecture; ``reduce_experiment`` cuts any
of them to toy dimensions for CPU tests, and ``smoke_experiment(arch)`` is
that cut of ``arch`` (the JAX package's ``repro.configs``).  Ported: the
dense decoders ``qwen2_5_3b``, ``llama3_8b``, ``starcoder2_15b`` and
``h2o_danube_3_4b``, the encoder-decoder ``whisper_small``, the VLM
``phi_3_vision_4_2b``, the MoE
models ``deepseek_moe_16b`` and ``grok_1_314b``, the xLSTM
``xlstm_350m``, the Mamba2 hybrid ``zamba2_1_2b`` and the paper's CNNs
(``paper_cnns``)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.core.config import Experiment

ARCH_IDS = ["deepseek_moe_16b", "grok_1_314b", "h2o_danube_3_4b",
            "starcoder2_15b", "llama3_8b", "qwen2_5_3b", "xlstm_350m",
            "whisper_small", "phi_3_vision_4_2b", "zamba2_1_2b"]


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_experiment(arch: str) -> Experiment:
    name = canon(arch)
    if name not in ARCH_IDS:
        raise NotImplementedError(f"architecture {arch!r} is not ported; "
                                  f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").get_config()


def smoke_experiment(arch: str) -> Experiment:
    """The reduced same-family config of ``arch`` (no config module of
    either package defines a ``smoke_config`` of its own, so this is the
    JAX package's ``smoke_experiment`` for every arch)."""
    return reduce_experiment(get_experiment(arch))


def reduce_experiment(exp: Experiment) -> Experiment:
    """Same family and block structure, toy dimensions (a copy of the JAX
    package's generic reduction)."""
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
        moe_d_ff=48 if m.moe_d_ff else 0,
        num_experts=min(m.num_experts, 4),
        num_shared_experts=min(m.num_shared_experts, 1),
        top_k=min(m.top_k, 2),
        vocab_size=128,
        ssm_state=min(m.ssm_state, 8) if m.ssm_state else 0,
        sliding_window=min(m.sliding_window, 8) if m.sliding_window else 0,
        encoder_layers=min(m.encoder_layers, 2),
        frontend_tokens=8 if m.frontend else 0,
        dtype="float32",
    )
    tr = dataclasses.replace(exp.train, global_batch=2, seq_len=16,
                             total_steps=8, microbatches=1)
    sv = dataclasses.replace(exp.serve, batch=2, prefill_len=16,
                             max_kv_len=32)
    return dataclasses.replace(exp, model=small, train=tr, serve=sv)
