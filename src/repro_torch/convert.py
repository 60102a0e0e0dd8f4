"""Carry parameter trees between the JAX package and this package.

The JAX package's trees are nested dicts/lists of numpy arrays (what
``jax.tree.map(np.asarray, ...)`` gives); nothing here needs JAX.

* ``state_dict_from_jax(params, model_state)``: a ``state_dict`` for
  :class:`repro_torch.models.resnet.ResNet` or
  :class:`~repro_torch.models.resnet.MobileNetV2`; the stacked ``rest``
  blocks of each ResNet stage are unstacked into per-block modules,
  MobileNetV2's ``blocks`` list is indexed as it stands, and conv weights
  stay patch-major ``(k*k*C, Cout)``.
* ``lm_state_dict_from_jax(params)``: a ``state_dict`` for
  :class:`repro_torch.models.transformer.TransformerLM`; the stacked
  ``units`` are unstacked into per-layer modules, and the attention weights
  keep their ``(d, n, h)`` / ``(n, h, d)`` layouts.
* ``jax_tree(named)``: the inverse, for any dict keyed by this package's
  parameter or buffer names (parameters, BatchNorm buffers, optimizer
  moments, the SWA average): the per-block ResNet modules stacked back into
  each stage's ``trans`` and ``rest`` (``down.w`` as ``down: {conv: {w}}``),
  the LM's layers into ``units.b0_attn``, and indexed modules back into
  lists (``stages``, MobileNetV2's ``blocks``), so that the flattening
  order is JAX's (block 10 after block 9, not after block 1).
* ``train_state_tree(state)``: a port ``TrainState`` as the JAX package's
  ``TrainState`` fields (``params``, ``opt``, ``swa``, ``step`` int32,
  ``model_state``), the tree ``ft/checkpoint.py`` writes;
  ``load_train_state(state, tree)`` puts such a tree back onto the module,
  the optimizer dict and the SWA dict, on their device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

STACKED = ("rest", "b0_attn")       # JAX tree keys over stacked blocks


def jax_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Where the port's ``name`` lives in the JAX package's tree: the key
    path, and the index along the stacked axis (``None`` if unstacked)."""
    parts = name.split(".")
    if parts[0] == "stages":                     # ResNet block
        stage, b, rest = parts[1], int(parts[2]), parts[3:]
        if rest[0] == "down":
            rest = ["down", "conv"] + rest[1:]
        if b == 0:
            return ("stages", stage, "trans", *rest), None
        return ("stages", stage, "rest", *rest), b - 1
    if parts[0] == "layers":                     # LM layer
        return ("units", "b0_attn", *parts[2:]), int(parts[1])
    return tuple(parts), None


def port_name(path: Tuple[str, ...], index: Optional[int]) -> str:
    """The inverse of :func:`jax_path`."""
    if path[0] == "stages":
        stage, where, rest = path[1], path[2], list(path[3:])
        if rest[:2] == ["down", "conv"]:
            rest = ["down"] + rest[2:]
        b = 0 if where == "trans" else index + 1
        return ".".join(["stages", stage, str(b), *rest])
    if path[:2] == ("units", "b0_attn"):
        return ".".join(["layers", str(index), *path[2:]])
    return ".".join(path)


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _lists(node: Any) -> Any:
    """Dicts keyed ``"0" .. "n-1"`` as lists, below ``node`` too."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(map(str, range(len(node)))):
        return [node[str(i)] for i in range(len(node))]
    return node


def jax_tree(named: Dict[str, Any]) -> Dict[str, Any]:
    """``named`` (port names -> tensors) as the JAX package's nested tree of
    numpy arrays; lists where the JAX tree has lists (a ResNet's
    ``stages``, MobileNetV2's ``blocks``)."""
    groups: Dict[Tuple[str, ...], Dict[Optional[int], np.ndarray]] = {}
    for name, t in named.items():
        path, i = jax_path(name)
        groups.setdefault(path, {})[i] = to_numpy(t)
    tree: Dict[str, Any] = {}
    for path, g in groups.items():
        leaf = g[None] if None in g else np.stack([g[i] for i in range(len(g))])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _lists(tree)


def children(node: Any):
    """A dict's or a sequence's children with their key strings, in JAX's
    flattening order (dict keys sorted, sequences by index)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return [(str(i), v) for i, v in enumerate(node)]


def leaves(tree: Any, path: Tuple[str, ...] = ()):
    """``(key path, leaf)`` of every leaf in JAX's order; ``None`` is an
    empty subtree, as in JAX."""
    if isinstance(tree, (dict, list, tuple)):
        for k, v in children(tree):
            yield from leaves(v, path + (k,))
    elif tree is not None:
        yield path, tree


def port_named(tree: Any) -> Dict[str, np.ndarray]:
    """The inverse of :func:`jax_tree`: port names -> numpy arrays, the
    stacked blocks unstacked."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in leaves(tree):
        stacked = next((j for j, k in enumerate(path) if k in STACKED), None)
        if stacked is None or stacked == len(path) - 1:
            out[port_name(path, None)] = np.asarray(leaf)
            continue
        for i in range(len(leaf)):
            out[port_name(path, i)] = np.asarray(leaf[i])
    return out


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def state_dict_from_jax(params: Dict[str, Any], model_state: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    return _tensors({**port_named(params), **port_named(model_state)})


def lm_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Only ``attn`` units of one block each (what the port builds)."""
    units = params["units"]
    if list(units) != ["b0_attn"]:
        raise NotImplementedError(f"units {sorted(units)}: only one-block "
                                  "'attn' units are ported")
    return _tensors(port_named(params))


# ---------------------------------------------------------------------------
# TrainState <-> the JAX package's TrainState tree
# ---------------------------------------------------------------------------

TRAIN_STATE_FIELDS = ("params", "opt", "swa", "step", "model_state")


def _counted(state: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer or SWA dict: name dicts as trees, counts as int32."""
    return {k: jax_tree(v) if isinstance(v, dict) else np.int32(v)
            for k, v in state.items()}


def train_state_tree(state) -> Dict[str, Any]:
    """A port :class:`~repro_torch.training.train_step.TrainState` as the
    fields of the JAX package's ``TrainState``, numpy arrays on the host
    (``None`` where the JAX field is ``None``: no SWA, the LM's
    ``model_state``)."""
    buffers = dict(state.model.named_buffers())
    return {"params": jax_tree(dict(state.model.named_parameters())),
            "opt": _counted(state.opt),
            "swa": None if state.swa is None else _counted(state.swa),
            "step": np.int32(state.step),
            "model_state": jax_tree(buffers) if buffers else None}


@torch.no_grad()
def _load_named(dst: Dict[str, torch.Tensor], tree: Any) -> None:
    src = port_named(tree)
    if set(src) != set(dst):
        raise ValueError(f"tree holds {sorted(set(src) ^ set(dst))[:5]} "
                         "where the model does not, or the reverse")
    for k, t in dst.items():
        t.copy_(torch.from_numpy(np.asarray(src[k])).to(t.dtype))


def _load_counted(dst: Dict[str, Any], tree: Dict[str, Any]) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _load_named(v, tree[k])
        else:
            dst[k] = int(tree[k])


def load_train_state(state, tree: Dict[str, Any]):
    """Copy ``tree`` (the layout of :func:`train_state_tree`) into
    ``state`` in place: parameters and buffers into the module, the
    optimizer and SWA tensors into theirs, on their devices; returns
    ``state``."""
    _load_named(dict(state.model.named_parameters()), tree["params"])
    buffers = dict(state.model.named_buffers())
    if buffers:
        _load_named(buffers, tree["model_state"])
    _load_counted(state.opt, tree["opt"])
    if state.swa is not None:
        _load_counted(state.swa, tree["swa"])
    state.step = int(tree["step"])
    return state
