"""Shape stand-ins for every model input of a dry-run cell (the JAX
package's ``launch/specs.py``).

Each is a tensor on the ``meta`` device: the shape and dtype the
production job would feed, with no storage and no draw (the counterpart of
``jax.ShapeDtypeStruct`` and ``jax.eval_shape``).  The train state is the
port's ``TrainState`` built on ``meta`` (``init_train_state(exp,
device="meta")``), the decode state ``init_decode_state(...,
device="meta")``; ``"params"`` of a serving cell is the model that holds
the parameters, which the port's serving steps take.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.config import SHAPES, Experiment
from repro_torch.models import transformer
from repro_torch.training import train_step as ts


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (a ``torch.dtype`` or
    its name)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(exp: Experiment) -> Dict[str, Any]:
    m, t = exp.model, exp.train
    specs = {"tokens": sds((t.global_batch, t.seq_len), torch.int32),
             "labels": sds((t.global_batch, t.seq_len), torch.int32)}
    if m.frontend:
        specs["frontend"] = sds((t.global_batch, m.frontend_tokens,
                                 m.d_model), m.dtype)
    return specs


def prefill_specs(exp: Experiment) -> Dict[str, Any]:
    m, s = exp.model, exp.serve
    specs = {"tokens": sds((s.batch, s.prefill_len), torch.int32)}
    if m.frontend:
        specs["frontend"] = sds((s.batch, m.frontend_tokens, m.d_model),
                                m.dtype)
    return specs


def decode_specs(exp: Experiment) -> Dict[str, Any]:
    m, s = exp.model, exp.serve
    state = transformer.init_decode_state(m, s.batch, s.max_kv_len,
                                          device="meta")
    specs = {"token": sds((s.batch, 1), torch.int32), "state": state}
    if m.encoder_layers:
        specs["memory"] = sds((s.batch, m.frontend_tokens, m.d_model),
                              m.dtype)
    return specs


def train_state_specs(exp: Experiment) -> ts.TrainState:
    return ts.init_train_state(exp, device="meta")


def input_specs(exp: Experiment, shape: str) -> Dict[str, Any]:
    """All inputs for an (arch x shape) dry-run cell."""
    exp = exp.with_shape(shape)
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        return {"state": train_state_specs(exp),
                "batch": train_batch_specs(exp)}
    if kind == "prefill":
        return {"params": train_state_specs(exp).model, **prefill_specs(exp)}
    return {"params": train_state_specs(exp).model, **decode_specs(exp)}
