"""Carry the JAX package's parameter trees over to this package.

Both functions take the JAX package's trees as nested dicts/lists of numpy
arrays (what ``jax.tree.map(np.asarray, ...)`` gives) and need no JAX.

* ``state_dict_from_jax(params, model_state)``: a ``state_dict`` for
  :class:`repro_torch.models.resnet.ResNet`; the stacked ``rest`` blocks of
  each stage are unstacked into per-block modules, and conv weights stay
  patch-major ``(k*k*C, Cout)``.
* ``lm_state_dict_from_jax(params)``: a ``state_dict`` for
  :class:`repro_torch.models.transformer.TransformerLM`; the stacked
  ``units`` are unstacked into per-layer modules, and the attention weights
  keep their ``(d, n, h)`` / ``(n, h, d)`` layouts.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

GATE_KEYS = ("proj", "lstm_wx", "lstm_wh", "lstm_b", "head_w", "head_b")


def _block(out: Dict[str, np.ndarray], prefix: str, blk: Dict[str, Any],
           bst: Dict[str, Any]) -> None:
    for conv in ("conv1", "conv2"):
        out[f"{prefix}.{conv}.w"] = blk[conv]["w"]
    for bn in ("bn1", "bn2"):
        out[f"{prefix}.{bn}.scale"] = blk[bn]["scale"]
        out[f"{prefix}.{bn}.bias"] = blk[bn]["bias"]
        out[f"{prefix}.{bn}.mean"] = bst[bn]["mean"]
        out[f"{prefix}.{bn}.var"] = bst[bn]["var"]
    if "down" in blk:
        out[f"{prefix}.down.w"] = blk["down"]["conv"]["w"]


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def _flatten(out: Dict[str, np.ndarray], prefix: str, tree: Any) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(out, f"{prefix}{k}.", v)
        else:
            out[f"{prefix}{k}"] = v


def state_dict_from_jax(params: Dict[str, Any], model_state: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {
        "stem.w": params["stem"]["w"],
        "stem_bn.scale": params["stem_bn"]["scale"],
        "stem_bn.bias": params["stem_bn"]["bias"],
        "stem_bn.mean": model_state["stem_bn"]["mean"],
        "stem_bn.var": model_state["stem_bn"]["var"],
        "fc_w": params["fc_w"], "fc_b": params["fc_b"]}
    for s, (sp, ss) in enumerate(zip(params["stages"], model_state["stages"])):
        _block(out, f"stages.{s}.0", sp["trans"], ss["trans"])
        if "rest" in sp:
            for b in range(len(sp["rest"]["conv1"]["w"])):
                _block(out, f"stages.{s}.{b + 1}", _index(sp["rest"], b),
                       _index(ss["rest"], b))
    if "slu_gate" in params:
        for k in GATE_KEYS:
            out[f"slu_gate.{k}"] = params["slu_gate"][k]
    return _tensors(out)


def lm_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Only ``attn`` units of one block each (what the port builds)."""
    units = params["units"]
    if list(units) != ["b0_attn"]:
        raise NotImplementedError(f"units {sorted(units)}: only one-block "
                                  "'attn' units are ported")
    out: Dict[str, np.ndarray] = {"embed": params["embed"]}
    if "head" in params:
        out["head"] = params["head"]
    _flatten(out, "final_norm.", params["final_norm"])
    stacked = units["b0_attn"]
    for i in range(len(stacked["ln1"]["scale"])):
        _flatten(out, f"layers.{i}.", _index(stacked, i))
    if "slu_gate" in params:
        _flatten(out, "slu_gate.", params["slu_gate"])
    return _tensors(out)
