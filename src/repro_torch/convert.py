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
  ``units`` (one key ``b{i}_{kind}`` per block of the unit, an MoE's
  ``shared`` experts a list inside), ``encoder`` and ``cross`` are
  unstacked into per-layer modules (``units.b{i}_{kind}[u]`` as
  ``layers.<u * len(unit) + i>``, ``encoder.<i>``, ``cross.<i>``), the
  top-level ``shared`` attention (zamba2) stays ``shared``, and the
  attention and expert weights keep their ``(d, n, h)`` / ``(n, h, d)`` /
  ``(E, d, f)`` layouts.
* ``jax_tree(named, unit=None)``: the inverse, for any dict keyed by this
  package's parameter or buffer names (parameters, BatchNorm buffers,
  optimizer moments, the SWA average): the per-block ResNet modules stacked
  back into each stage's ``trans`` and ``rest`` (``down.w`` as ``down:
  {conv: {w}}``), the LM's layers into ``units`` by ``unit``, the model's
  tuple of block kinds (default: one ``attn`` block, one ``moe`` block when
  the layers hold an ``moe``; a ``shared_attn`` block keeps its empty
  subtree), its encoder and cross-attention layers into ``encoder`` and
  ``cross``, and indexed modules back into lists (``stages``,
  MobileNetV2's ``blocks``, the shared experts), so that the flattening
  order is JAX's (sorted keys: block 10 after block 9, not after block 1;
  ``b10_mamba`` before ``b1_mamba``).  bf16 tensors leave as
  fp32 arrays of the same values (numpy has no bf16; the JAX package's
  ``astype`` restores its dtype exactly).
* ``decode_state_tree(state, unit_len)`` and
  ``decode_state_from_tree(tree, device)``: a serving decode state
  (``models/transformer.DecodeState``: one entry a layer) as the JAX
  package's ``{"units": {"b{i}": stacked over units}, "pos"}`` tree of
  numpy arrays, and back (a bf16 array, numpy's ``ml_dtypes`` type, comes
  back as a bf16 tensor; a JAX ``kv`` pair is a tuple in both).
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

# JAX tree keys over stacked blocks (and every key under ``units``)
STACKED = ("rest", "encoder", "cross")
LM_STACKED = ("encoder", "cross")       # top-level stacks named as in JAX
SHARED_ATTN = "shared_attn"             # a unit's block with no parameters

Unit = Tuple[str, ...]


def lm_unit(names) -> Unit:
    """The unit of one-block LM layers: ``("moe",)`` when any layer holds
    an ``moe``, else ``("attn",)``."""
    moe = any(n.split(".")[:3:2] == ["layers", "moe"] for n in names)
    return ("moe",) if moe else ("attn",)


def jax_path(name: str, unit: Unit = ("attn",)
             ) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Where the port's ``name`` lives in the JAX package's tree: the key
    path, and the index along the stacked axis (``None`` if unstacked);
    ``unit`` is the LM's tuple of block kinds."""
    parts = name.split(".")
    if parts[0] == "stages":                     # ResNet block
        stage, b, rest = parts[1], int(parts[2]), parts[3:]
        if rest[0] == "down":
            rest = ["down", "conv"] + rest[1:]
        if b == 0:
            return ("stages", stage, "trans", *rest), None
        return ("stages", stage, "rest", *rest), b - 1
    if parts[0] == "layers":                     # LM layer
        u, i = divmod(int(parts[1]), len(unit))
        return ("units", f"b{i}_{unit[i]}", *parts[2:]), u
    if parts[0] in LM_STACKED:                   # encoder or cross layer
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def port_name(path: Tuple[str, ...], index: Optional[int],
              unit_len: int = 1) -> str:
    """The inverse of :func:`jax_path`; ``unit_len`` is the number of
    blocks a unit (of keys under ``units``)."""
    if path[0] == "stages":
        stage, where, rest = path[1], path[2], list(path[3:])
        if rest[:2] == ["down", "conv"]:
            rest = ["down"] + rest[2:]
        b = 0 if where == "trans" else index + 1
        return ".".join(["stages", stage, str(b), *rest])
    if path[0] == "units":
        i = int(path[1][1:].split("_")[0])
        return ".".join(["layers", str(index * unit_len + i), *path[2:]])
    if path[0] in LM_STACKED:
        return ".".join([path[0], str(index), *path[1:]])
    return ".".join(path)


def to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _lists(node: Any) -> Any:
    """Dicts keyed ``"0" .. "n-1"`` as lists, below ``node`` too."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(map(str, range(len(node)))):
        return [node[str(i)] for i in range(len(node))]
    return node


def jax_tree(named: Dict[str, Any], unit: Optional[Unit] = None
             ) -> Dict[str, Any]:
    """``named`` (port names -> tensors) as the JAX package's nested tree of
    numpy arrays; lists where the JAX tree has lists (a ResNet's
    ``stages``, MobileNetV2's ``blocks``); ``unit`` the LM's tuple of block
    kinds (default :func:`lm_unit`)."""
    groups: Dict[Tuple[str, ...], Dict[Optional[int], np.ndarray]] = {}
    unit = unit or lm_unit(named)
    for name, t in named.items():
        path, i = jax_path(name, unit)
        groups.setdefault(path, {})[i] = to_numpy(t)
    tree: Dict[str, Any] = {}
    for path, g in groups.items():
        leaf = g[None] if None in g else np.stack([g[i] for i in range(len(g))])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    if "units" in tree:
        for i, kind in enumerate(unit):
            if kind == SHARED_ATTN:
                tree["units"][f"b{i}_{kind}"] = {}
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
    unit_len = len(tree["units"]) \
        if isinstance(tree, dict) and "units" in tree else 1
    for path, leaf in leaves(tree):
        stacked = 1 if path[0] == "units" else next(
            (j for j, k in enumerate(path) if k in STACKED), None)
        if stacked is None or stacked == len(path) - 1:
            out[port_name(path, None)] = np.asarray(leaf)
            continue
        for i in range(len(leaf)):
            out[port_name(path, i, unit_len)] = np.asarray(leaf[i])
    return out


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def state_dict_from_jax(params: Dict[str, Any], model_state: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    return _tensors({**port_named(params), **port_named(model_state)})


def lm_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Units of any blocks (keys ``b{i}_{kind}``, ``i`` the block's place),
    zamba2's top-level ``shared`` attention, and the enc-dec's ``encoder``,
    ``enc_norm`` and ``cross``."""
    keys = sorted(params["units"], key=lambda k: int(k[1:].split("_")[0]))
    if [int(k[1:].split("_")[0]) for k in keys] != list(range(len(keys))):
        raise ValueError(f"units {keys}: expected keys b0_... to "
                         f"b{len(keys) - 1}_...")
    return _tensors(port_named(params))


# ---------------------------------------------------------------------------
# serving decode state <-> the JAX package's decode-state tree
# ---------------------------------------------------------------------------


def _stacked(nodes):
    """Leaves of equal trees (dicts, tuples) stacked along a new axis 0."""
    if isinstance(nodes[0], dict):
        return {k: _stacked([n[k] for n in nodes]) for k in nodes[0]}
    if isinstance(nodes[0], tuple):
        return tuple(_stacked(list(n)) for n in zip(*nodes))
    return np.stack([to_numpy(n) for n in nodes])


def _tensor(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":               # ml_dtypes: not for torch
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _unstacked(node, u: int, device=None):
    if isinstance(node, dict):
        return {k: _unstacked(v, u, device) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_unstacked(v, u, device) for v in node)
    return _tensor(np.asarray(node)[u], device)


def decode_state_tree(state: Dict[str, Any], unit_len: int
                      ) -> Dict[str, Any]:
    """A port decode state (``{"layers": [...], "pos"}``) as the JAX
    package's tree: layer ``j`` is entry ``j // unit_len`` of
    ``units["b{j % unit_len}"]``."""
    layers = state["layers"]
    return {"units": {f"b{i}": _stacked(layers[i::unit_len])
                      for i in range(unit_len)},
            "pos": to_numpy(state["pos"])}


def decode_state_from_tree(tree: Dict[str, Any], device=None
                           ) -> Dict[str, Any]:
    """The inverse of :func:`decode_state_tree`, as tensors on
    ``device``."""
    units = tree["units"]
    unit_len = len(units)
    n_units = len(next(leaves(units))[1])
    layers = [_unstacked(units[f"b{j % unit_len}"], j // unit_len, device)
              for j in range(n_units * unit_len)]
    return {"layers": layers, "pos": _tensor(tree["pos"], device)}


# ---------------------------------------------------------------------------
# TrainState <-> the JAX package's TrainState tree
# ---------------------------------------------------------------------------

TRAIN_STATE_FIELDS = ("params", "opt", "swa", "step", "model_state")


def _counted(state: Dict[str, Any], unit: Optional[Unit] = None
             ) -> Dict[str, Any]:
    """An optimizer or SWA dict: name dicts as trees, counts as int32."""
    return {k: jax_tree(v, unit) if isinstance(v, dict) else np.int32(v)
            for k, v in state.items()}


def train_state_tree(state) -> Dict[str, Any]:
    """A port :class:`~repro_torch.training.train_step.TrainState` as the
    fields of the JAX package's ``TrainState``, numpy arrays on the host
    (``None`` where the JAX field is ``None``: no SWA, the LM's
    ``model_state``)."""
    buffers = dict(state.model.named_buffers())
    unit = getattr(state.model, "unit", None)   # an LM's block kinds
    return {"params": jax_tree(dict(state.model.named_parameters()), unit),
            "opt": _counted(state.opt, unit),
            "swa": None if state.swa is None else _counted(state.swa, unit),
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
