"""Carry the JAX package's ResNet trees over to this package.

``state_dict_from_jax(params, model_state)`` takes the JAX package's
``(params, model_state)`` as nested dicts/lists of numpy arrays (what
``jax.tree.map(np.asarray, ...)`` gives) and returns a ``state_dict`` for
:class:`repro_torch.models.resnet.ResNet`: the stacked ``rest`` blocks of
each stage are unstacked into per-block modules, and conv weights stay
patch-major ``(k*k*C, Cout)``.  Needs no JAX.
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
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
