"""Logical-axis sharding rules, placements, and the collectives of the
global computation (the JAX package's ``distributed/sharding.py``).

Three layers:

* **Spec logic**, plain Python: every leaf is matched by its JAX key path
  (``convert.jax_path``) against :data:`RULES`, which give logical axes per
  dimension; logical axes map to mesh axes (:data:`LOGICAL_TO_MESH`), and a
  logical axis is dropped where the mesh axis does not divide the
  dimension.  A spec is a tuple with one entry per dimension: a mesh axis
  name, a tuple of names, or ``None``; compared as tuples it equals the
  JAX package's ``PartitionSpec``.  A mesh is anything with axis names
  and sizes: an :class:`AbstractMesh` (no devices, the counterpart of
  ``make_abstract_mesh``) or a ``torch.distributed`` ``DeviceMesh``.
* **Placements**: :func:`param_shardings` and :func:`state_shardings` give
  each leaf one ``Shard(dim)`` or ``Replicate()`` per mesh dimension;
  :func:`batch_sharding` gives each batch leaf its spec and
  :func:`rank_rows` a rank's rows of the global batch;
  :func:`decode_state_shardings` is spec logic only.
* **Activation hooks**: :func:`activation_sharding` is the context the
  trainer enters around a step; :func:`ctx_mesh_axis_size` reads it.
  :func:`hint` and :func:`hint_batch` pin an activation to a logical spec
  (:data:`ACT_AXES`) where the program runs on ``DTensor``s
  (``activation_sharding(mesh, spmd=True)``, the dry run's
  ``launch/dryrun.py``): they redistribute a ``DTensor`` to it, as the
  JAX package's placement constraints place an array, and return a plain
  tensor as it is.  ``replicate`` and ``constrain_like_params`` are the
  identity.

The **collectives** (:func:`global_max`, :func:`global_sum`,
:func:`global_sum_int64`, :func:`global_amax`, :func:`global_mean`) turn a
rank's part of a reduction over the batch into the global batch's: where
the JAX package computes one global program over a mesh, each rank here
holds only its rows, so every place where the model couples rows (a
per-tensor quantization scale, a PSG weight-gradient sum, BatchNorm's
statistics, the SLU gate's pooled feature, the MoE's aux loss, the loss)
reduces across the data axis.  Outside :func:`activation_sharding`, under
an abstract mesh, where the data axis has one rank, or in a program on
``DTensor``s (whose every reduction is the global tensor's already), each
is the identity, so a path outside a mesh runs exactly the code it ran
before.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Spec = Tuple[Any, ...]


class AbstractMesh:
    """A device-free mesh for spec logic: ``AbstractMesh((2, 4), ("data",
    "model"))``; ``axis_names`` and ``shape`` (name -> size) as a JAX
    mesh has them."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    return {n: mesh.size(i) for i, n in enumerate(names)}


# ---------------------------------------------------------------------------
# spec logic (copies of the JAX package's rule table and its helpers)
# ---------------------------------------------------------------------------

# (path regex, candidate logical-axes specs).  Axes are right-aligned
# against the shape; a candidate list takes the first candidate whose named
# axes all divide (expert parallelism, else tensor parallelism in experts).
RULES: Tuple[Tuple[str, Any], ...] = (
    # embeddings / head
    (r"embed$",                ("tp_vocab", "fsdp")),
    (r"head$",                 ("fsdp", "tp_vocab")),
    # attention
    (r"attn/w[q]$",            ("fsdp", "tp", None)),
    (r"attn/w[kv]$",           ("fsdp", "tp", None)),
    (r"attn/wo$",              ("tp", None, "fsdp")),
    (r"attn/b[qkv]$",          ("tp", None)),
    # dense MLP
    (r"mlp/w_(up|gate)$",      ("fsdp", "tp")),
    (r"mlp/w_down$",           ("tp", "fsdp")),
    (r"mlp/b_up$",             ("tp",)),
    (r"mlp/b_down$",           (None,)),
    # MoE (expert parallelism over the model axis; TP fallback)
    (r"moe/router$",           (None, None)),
    (r"moe/w_(up|gate)$",      [("expert", "fsdp", None),
                                (None, "fsdp", "tp")]),
    (r"moe/w_down$",           [("expert", None, "fsdp"),
                                (None, "tp", "fsdp")]),
    (r"moe/shared/.*w_(up|gate)$", ("fsdp", "tp")),
    (r"moe/shared/.*w_down$",  ("tp", "fsdp")),
    # Mamba2
    (r"mamba/w_in$",           ("fsdp", "tp")),
    (r"mamba/w_out$",          ("tp", "fsdp")),
    (r"mamba/conv$",           (None, "tp")),
    (r"mamba/w_bc$",           ("fsdp", None)),
    (r"mamba/w_dt$",           ("fsdp", None)),
    # xLSTM
    (r"mlstm/w_in$",           ("fsdp", "tp")),
    (r"mlstm/w_out$",          ("tp", "fsdp")),
    (r"mlstm/w(q|k|v)$",       ("tp", None, None)),
    (r"mlstm/w_if$",           ("tp", None)),
    (r"slstm/w_g$",            ("fsdp", "tp")),
    (r"slstm/w_out$",          ("tp", "fsdp")),
    (r"slstm/r_g$",            ("tp_heads", None, None)),
    # norms, gates, scalars: replicated
    (r".*",                    ()),
)

LOGICAL_TO_MESH: Dict[str, Tuple[str, ...]] = {
    "tp": ("model",),
    "tp_vocab": ("model",),
    "tp_heads": ("model",),
    "expert": ("model",),
    "fsdp": ("data",),           # extended with 'pod' when multi-pod
}


def logical_rules(path_s: str):
    for pat, axes in RULES:
        if re.search(pat, path_s):
            return axes
    return ()


def _candidates(logical):
    return logical if isinstance(logical, list) else [logical]


def _mesh_axes_for(name: str, shape: Dict[str, int], fsdp: bool):
    if name == "fsdp" and not fsdp:
        return ()
    mesh_axes = tuple(a for a in LOGICAL_TO_MESH.get(name, ()) if a in shape)
    if name == "fsdp":
        mesh_axes = tuple(a for a in ("pod",) if a in shape) + mesh_axes
    return mesh_axes


def _try_spec(shape, logical, mesh_sz: Dict[str, int], fsdp: bool):
    """``(spec, all named axes applied)``."""
    ndim = len(shape)
    axes: list = [None] * ndim
    complete = True
    offset = ndim - len(logical)
    for i, name in enumerate(logical):
        if name is None or offset + i < 0:
            continue
        mesh_axes = _mesh_axes_for(name, mesh_sz, fsdp)
        size = int(np.prod([mesh_sz[a] for a in mesh_axes])) if mesh_axes \
            else 1
        if mesh_axes and size > 1 and shape[offset + i] % size == 0:
            axes[offset + i] = mesh_axes if len(mesh_axes) > 1 \
                else mesh_axes[0]
        elif name != "fsdp":
            complete = False
    return tuple(axes), complete


def _spec_for(shape: Tuple[int, ...], logical, mesh, fsdp: bool) -> Spec:
    """Right-align the logical axes to ``shape`` and drop the shardings
    that do not divide; of a candidate list, the first candidate whose
    non-fsdp axes all apply, else the first's partial application."""
    cands = _candidates(logical)
    if not cands or not cands[0]:
        return (None,) * len(shape)
    sz = mesh_shape(mesh)
    first = None
    for cand in cands:
        spec, complete = _try_spec(shape, cand, sz, fsdp)
        if first is None:
            first = spec
        if complete:
            return spec
    return first


def leaf_path(name: str, unit=None) -> str:
    """The JAX key path (``a/b/c``) of the port's parameter ``name``; the
    port's leaf lacks the JAX leaf's leading stacked axis, which the rules'
    right alignment never names."""
    from repro_torch.convert import jax_path, lm_unit
    return "/".join(jax_path(name, unit or lm_unit([name]))[0])


def param_specs(named: Dict[str, Any], mesh, fsdp: bool = True,
                unit=None) -> Dict[str, Spec]:
    """``{name: spec}`` for a dict of the port's named tensors (or shapes),
    matched by their JAX paths; ``unit`` is an LM's tuple of block kinds
    (default: ``convert.lm_unit`` of the names)."""
    from repro_torch.convert import lm_unit
    unit = unit or lm_unit(named)
    return {k: _spec_for(tuple(v.shape), logical_rules(leaf_path(k, unit)),
                         mesh, fsdp)
            for k, v in named.items()}


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """One ``Shard(dim)`` or ``Replicate()`` per mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_shape(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_dim(spec: Spec, axis: str = "data") -> Optional[int]:
    """The dimension ``spec`` shards over ``axis``, or ``None``."""
    for d, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return d
    return None


def param_shardings(model, mesh, fsdp: bool = True, unit=None
                    ) -> Dict[str, Tuple[Any, ...]]:
    """``{name: placements}`` of a module's parameters, by their whole
    shapes also where the module holds shards (``fsdp.whole_shapes``), or
    of a dict of named tensors."""
    if hasattr(model, "named_parameters"):
        from repro_torch.distributed.fsdp import whole_shapes
        named = whole_shapes(model)
    else:
        named = model
    unit = unit or getattr(model, "unit", None)
    return {k: placements(s, mesh)
            for k, s in param_specs(named, mesh, fsdp, unit).items()}


def state_shardings(state, mesh, fsdp: bool = True) -> Dict[str, Any]:
    """The placements of a ``TrainState``: ``params``, and each optimizer
    and SWA dict of named tensors, mirror the parameters' (the moments
    have their shapes); the BatchNorm buffers and the counts (host
    integers) are replicated."""
    from torch.distributed.tensor import Replicate
    rep = tuple(Replicate() for _ in mesh_shape(mesh))
    params = param_shardings(state.model, mesh, fsdp)

    def counted(d):
        return {k: ({n: params[n] for n in v} if isinstance(v, dict)
                    else rep) for k, v in d.items()}

    return {"params": params, "opt": counted(state.opt),
            "swa": None if state.swa is None else counted(state.swa),
            "model_state": {k: rep for k, _ in state.model.named_buffers()},
            "step": rep}


def _leaf_batch_spec(mesh_sz: Dict[str, int], ndim: int, shape,
                     seq_shard: bool, batch_axis: int) -> Spec:
    if batch_axis >= ndim:
        return (None,) * ndim
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh_sz)
    bsize = int(np.prod([mesh_sz[a] for a in batch_axes])) if batch_axes \
        else 1
    if bsize <= 1 or (shape is not None and shape[batch_axis] % bsize):
        batch_axes = ()
    axes: list = [None] * ndim
    axes[batch_axis] = (batch_axes if len(batch_axes) > 1 else
                        (batch_axes[0] if batch_axes else None))
    seq_axis = batch_axis + 1
    if seq_shard and "model" in mesh_sz and ndim > seq_axis:
        if shape is None or shape[seq_axis] % mesh_sz["model"] == 0:
            axes[seq_axis] = "model"
    return tuple(axes)


def batch_sharding(mesh, batch: Any = 2, seq_shard: bool = False,
                   shape: Optional[Tuple[int, ...]] = None,
                   batch_axis: int = 0):
    """The batch axis over pod+data, optionally the next (sequence) axis
    over model; an axis that does not divide is dropped.  ``batch`` is an
    int rank (with the optional ``shape``) or a dict batch, whose leaves
    each get their spec; ``batch_axis`` is 1 for chunk-stacked batches."""
    sz = mesh_shape(mesh)
    if isinstance(batch, int):
        return _leaf_batch_spec(sz, batch, shape, seq_shard, batch_axis)
    return {k: _leaf_batch_spec(sz, len(v.shape), tuple(v.shape), seq_shard,
                                batch_axis) for k, v in batch.items()}


def rank_rows(batch: Dict[str, torch.Tensor], rank: int, world: int,
              microbatches: int = 1, batch_axis: int = 0
              ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s rows of a global batch, in the order in which the
    JAX package shards each of ``microbatches`` microbatches: the global
    batch splits into ``m`` microbatches of ``B / m`` rows, each of which
    splits over the ``world`` ranks, so the rank's part of microbatch ``i``
    is global rows ``i B/m + rank B/(m W)`` .. ``+ B/(m W)``, and its
    microbatches in order are :func:`training.train_step.split_microbatches`
    of what this returns.  A leaf without the batch axis is returned as it
    is; a batch axis that ``m W`` does not divide raises."""
    if world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.dim() <= batch_axis:
            out[k] = v
            continue
        B = v.shape[batch_axis]
        if B % (microbatches * world):
            raise ValueError(
                f"batch {k!r}: {B} rows do not split into {microbatches} "
                f"microbatch(es) over {world} ranks")
        shp = v.shape
        g = v.reshape(*shp[:batch_axis], microbatches, world,
                      B // (microbatches * world), *shp[batch_axis + 1:])
        out[k] = g.select(batch_axis + 1, rank).reshape(
            *shp[:batch_axis], B // world, *shp[batch_axis + 1:])
    return out


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def decode_state_shardings(state_tree, mesh):
    """Specs of a decode state in the JAX package's layout
    (``convert.decode_state_tree``): the batch over pod+data; a KV cache
    ``(units, B, T, nkv, hd)`` its kv heads over model, else its slots; a
    recurrent state its widest inner axis over model, where divisible.
    Serving under a mesh is not ported: this is the spec logic alone."""
    sz = mesh_shape(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sz)
    bsize = int(np.prod([sz[a] for a in batch_axes])) if batch_axes else 1
    b_axis = batch_axes if len(batch_axes) > 1 else (
        batch_axes[0] if batch_axes else None)
    msize = sz.get("model", 1)

    def one(path, leaf):
        shape = tuple(np.shape(leaf))
        ndim = len(shape)
        if ndim == 0:
            return ()
        path_s = "/".join(path)
        axes: list = [None] * ndim
        bpos = 1 if "units" in path_s else 0
        if ndim > bpos and bsize > 1 and shape[bpos] % bsize == 0:
            axes[bpos] = b_axis
        if "kv" in path_s and ndim >= bpos + 3 and "model" in sz:
            if shape[bpos + 2] % msize == 0:
                axes[bpos + 2] = "model"          # kv-heads axis
            elif shape[bpos + 1] % msize == 0:
                axes[bpos + 1] = "model"          # T axis
        elif ndim > bpos + 1 and "model" in sz:
            rest = list(range(bpos + 1, ndim))
            j = max(rest, key=lambda i: shape[i])
            if shape[j] % msize == 0:
                axes[j] = "model"
        return tuple(axes)

    return _tree_map(one, state_tree)


# ---------------------------------------------------------------------------
# activation hooks
# ---------------------------------------------------------------------------

# the active mesh: process-wide, not per thread, since autograd runs the
# backward of CUDA ops on a thread of its own, where the PSG ops' backward
# reduces across ranks too; _SPMD: the program runs on DTensors
_ACTIVE: Optional[Any] = None
_SPMD = False

# logical activation axes -> mesh axes (the JAX package's ACT_AXES)
ACT_AXES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "mlp": ("model",),
    "seq": ("model",),        # SP: sequence over model axis (training path)
    "tokens": ("pod", "data", "model"),   # flattened batch*seq (MoE groups)
}


@contextlib.contextmanager
def activation_sharding(mesh, spmd: bool = False):
    """Make ``mesh`` the active one.  By default each rank runs its rows of
    the batch and the collectives below reduce over its data axis inside
    this context; ``spmd=True`` runs one global program on ``DTensor``s
    over ``mesh`` (``launch/dryrun.py``): the collectives are identities
    and :func:`hint`/:func:`hint_batch` place the activations."""
    global _ACTIVE, _SPMD
    prev, _ACTIVE = (_ACTIVE, _SPMD), mesh
    _SPMD = spmd
    try:
        yield
    finally:
        _ACTIVE, _SPMD = prev


def ctx_mesh_axis_size(name: str) -> int:
    """Size of an axis of the active mesh; 1 without one or without the
    axis."""
    if _ACTIVE is None:
        return 1
    return mesh_shape(_ACTIVE).get(name, 1)


def _act_spec(shape, logical_axes, sz: Dict[str, int]) -> list:
    """The JAX package's ``hint`` spec: each named dimension its mesh axes
    (not taken by an earlier dimension) where their size divides it, an
    unnamed one ``None``."""
    spec: list = []
    used: set = set()
    for i, name in enumerate(logical_axes):
        axes = tuple(a for a in ACT_AXES.get(name, ())
                     if a in sz and a not in used) if name else ()
        size = int(np.prod([sz[a] for a in axes])) if axes else 1
        if axes and size > 1 and shape[i] % size == 0:
            spec.append(axes)
            used.update(axes)
        else:
            spec.append(None)
    return spec


def act_placements(shape, logical_axes, mesh) -> Tuple[Any, ...]:
    """The placements of the logical spec ``logical_axes`` for an
    activation of ``shape`` on ``mesh`` (unnamed dimensions replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    spec = _act_spec(tuple(shape), logical_axes, mesh_shape(mesh))
    named = {a: d for d, axes in enumerate(spec) if axes for a in axes}
    return tuple(Shard(named[a]) if a in named else Replicate()
                 for a in mesh.mesh_dim_names)


def run_local(fn: Callable, args, specs, out_spec, n_out: int = 1,
              partial: Optional[Tuple[Any, ...]] = None,
              out_shape=None, inplace: Tuple[int, ...] = ()):
    """``fn(*args)`` on each rank's shards: ``args`` (``DTensor``s) are
    placed by their logical specs, ``fn`` runs on the local tensors (the
    plain code of the port, communication-free), and its output (``n_out``
    of them, a tuple above 1) is placed by ``out_spec`` as a tensor of
    ``out_shape`` (default: the first argument's) would be (``local_map``;
    the backward keeps the placements).  ``partial = (axis, size[, op])``:
    ``fn`` reduces a dimension of ``size`` sharded over the logical
    ``axis`` where its mesh axes divide it, so the output is a partial
    result over them (a sum, or ``op``).  The arguments at ``inplace``,
    which ``fn`` writes, must be in their spec's placements already (a
    redistributed copy would take the writes).  On plain tensors,
    ``fn(*args)``."""
    if not spmd(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    # one list of placements a tensor (a tuple is local_map's per-output)
    in_pl = tuple(list(act_placements(a.shape, sp, mesh))
                  for a, sp in zip(args, specs))
    for i in inplace:          # (a mesh axis of one rank places nothing)
        if any(a != b and mesh.size(d) > 1 for d, (a, b) in
               enumerate(zip(in_pl[i], args[i].placements))):
            raise ValueError(f"argument {i} is written in place but placed "
                             f"{args[i].placements}, not {in_pl[i]}")
    out_pl = list(act_placements(args[0].shape if out_shape is None
                                 else out_shape, out_spec, mesh))
    if partial is not None:
        summed = _act_spec((partial[1],), (partial[0],), mesh_shape(mesh))[0]
        op = partial[2] if len(partial) > 2 else "sum"
        out_pl = [Partial(op) if a in (summed or ()) else p
                  for a, p in zip(mesh.mesh_dim_names, out_pl)]
    if n_out > 1:
        out_pl = tuple(list(out_pl) for _ in range(n_out))
    # an argument replicated over a mesh axis that shards another one gets
    # from each rank of the axis the part of its gradient that the rank's
    # shard adds: a partial sum over the axis, not the whole
    split = {d for pl in in_pl for d, p in enumerate(pl)
             if isinstance(p, Shard)}
    grad_pl = tuple([Partial("sum") if d in split and
                     isinstance(p, Replicate) else p
                     for d, p in enumerate(pl)] for pl in in_pl)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def hint(x, *logical_axes: Optional[str], free: bool = False):
    """Pin the ``DTensor`` ``x`` to the logical spec (one name of
    :data:`ACT_AXES` or ``None`` a dimension) inside
    ``activation_sharding(mesh, spmd=True)``; ``free=True`` leaves the
    placements over the mesh axes no named dimension takes as they are,
    where the default replicates them.  A plain tensor, or no such
    context, returns ``x``: each rank of a data-parallel mesh holds its
    rows already."""
    if not _SPMD or not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    spec = _act_spec(tuple(x.shape), logical_axes, mesh_shape(mesh))
    named = {a: d for d, axes in enumerate(spec) if axes for a in axes}
    out = []
    for axis, cur in zip(names, x.placements):
        if axis in named:
            out.append(Shard(named[axis]))
        elif free and not (isinstance(cur, Shard) and spec[cur.dim]):
            out.append(cur)
        else:
            out.append(Replicate())
    out = tuple(out)
    return x if out == tuple(x.placements) else x.redistribute(mesh, out)


def hint_batch(x, axis: int = 0):
    """Pin only the batch axis of the ``DTensor`` ``x``; its other
    placements stay (a plain tensor returns as it is)."""
    if not _SPMD or not _is_dtensor(x):
        return x
    spec: list = [None] * x.ndim
    spec[axis] = "batch"
    return hint(x, *spec, free=True)


def sharded_by(x, axis: str) -> Optional[int]:
    """The dimension of the ``DTensor`` ``x`` that the mesh axis ``axis``
    shards, or ``None``."""
    from torch.distributed.tensor import Shard
    names = x.device_mesh.mesh_dim_names
    p = x.placements[names.index(axis)] if axis in names else None
    return p.dim if isinstance(p, Shard) else None


def shard_start(x, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of the
    ``DTensor`` ``x``, whose shards along it are even."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    first, n = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            first = first * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    return first * (x.shape[dim] // n)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spmd(x) -> bool:
    """Whether ``x`` is a ``DTensor`` of a program run under
    ``activation_sharding(mesh, spmd=True)``: where the models take the
    partitionable form of an op whose plain form ``DTensor`` would gather
    whole (the forms below; on plain tensors the plain ops run)."""
    return _SPMD and _is_dtensor(x)


def logsumexp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.logsumexp``; on ``DTensor``s the max, the sum and the log
    as three ops, so that a sharded ``dim`` reduces as partial results
    (``DTensor`` gathers the whole axis for the fused op)."""
    if not spmd(x):
        return torch.logsumexp(x, dim=dim)
    return _ShardedLogSumExp.apply(x, dim % x.ndim)


class _ShardedLogSumExp(torch.autograd.Function):
    """``logsumexp`` over the last, vocabulary-sharded axis of a
    ``DTensor``, each step on the local shards (``run_local``): the max and
    the sum partial results, pinned whole; the backward ``g * exp(x -
    lse)`` keeps the axis sharded."""

    @staticmethod
    def forward(ctx, x, dim):
        if dim != x.ndim - 1:
            raise ValueError("the sharded logsumexp reduces the last axis")
        rows = ("batch",) + (None,) * (x.ndim - 2)
        whole, vocab = rows + (None,), rows + ("vocab",)
        V = x.shape[-1]
        m = hint(run_local(lambda x: x.amax(dim=-1, keepdim=True), (x,),
                           (vocab,), whole, partial=("vocab", V, "max")),
                 *whole)
        s = hint(run_local(lambda x, m: (x - m).exp().sum(dim=-1,
                                                           keepdim=True),
                           (x, m), (vocab, whole), whole,
                           partial=("vocab", V)), *whole)
        lse = s.log() + m
        ctx.save_for_backward(x, lse)
        ctx.specs = (vocab, whole)
        return lse.squeeze(-1)

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        vocab, whole = ctx.specs
        return run_local(lambda x, lse, g: g[..., None] * (x - lse).exp(),
                         (x, lse, g), (vocab, whole, whole[:-1]),
                         vocab), None


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """``table[ids].to(dtype)``; on ``DTensor``s the table is cast, then
    gathered whole (an FSDP gather) and looked up with ``F.embedding``:
    ``DTensor`` has no rule for the indexing op's backward (an
    accumulating ``index_put``) in every release, nor for summing a
    vocabulary-sharded lookup's gradient (a masked partial) with the tied
    head's (a partial sum)."""
    if not spmd(table):
        return table[ids].to(dtype)
    from torch.distributed.tensor import Replicate
    whole = table.to(dtype).redistribute(
        table.device_mesh, [Replicate()] * table.device_mesh.ndim)
    return torch.nn.functional.embedding(ids, whole)


def take_last(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``logits[..., idx]`` per row (``idx`` one id a row, >= 0): a
    ``gather``; on ``DTensor``s a select against the ids of each shard of
    the last axis, summed, which keeps that axis sharded in the forward and
    the backward (``DTensor``'s ``gather`` backward scatters into the whole
    global shape)."""
    if not spmd(logits):
        return logits.gather(-1, idx[..., None].long())[..., 0]
    mesh = logits.device_mesh
    V = logits.shape[-1]
    axes = _act_spec((V,), ("vocab",), mesh_shape(mesh))[0] or ()
    coord = mesh.get_coordinate()
    first = 0               # this rank's first id of the last axis
    for a in axes:
        i = mesh.mesh_dim_names.index(a)
        first = first * mesh.size(i) + coord[i]
    rows = ("batch",) + (None,) * (logits.ndim - 2)

    def local(logits, idx):
        n = logits.shape[-1]
        ids = torch.arange(first * n, (first + 1) * n, device=idx.device)
        return torch.where(ids == idx[..., None], logits,
                           logits.new_zeros(())).sum(-1)
    return run_local(local, (logits, idx), (rows + ("vocab",), rows), rows,
                     partial=("vocab", V))


def replicate(x):
    # a gathered weight is whole on every rank (distributed/fsdp.py)
    return x


def constrain_like_params(tree, fsdp: bool = True):
    # the gradients' placement is distributed/fsdp.py's reduction
    return tree


# ---------------------------------------------------------------------------
# collectives of the global computation
# ---------------------------------------------------------------------------


def data_group():
    """The active mesh's data-axis process group, or ``None`` where the
    computation is one rank's (no active mesh, an abstract one, or a data
    axis of one rank) or one global program on ``DTensor``s."""
    mesh = _ACTIVE
    if mesh is None or _SPMD or isinstance(mesh, AbstractMesh):
        return None
    sz = mesh_shape(mesh)
    if sz.get("pod", 1) > 1:
        raise NotImplementedError("the port reduces over the data axis "
                                  "alone: a pod axis above 1 is not ported")
    if sz.get("data", 1) == 1:
        return None
    return mesh.get_group("data")


def data_world() -> int:
    """Ranks of the active data axis (1 outside a mesh)."""
    g = data_group()
    return 1 if g is None else torch.distributed.get_world_size(g)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    out = t.detach().clone()
    if out.dtype == torch.bfloat16:   # not every backend reduces bf16
        f = out.float()
        torch.distributed.all_reduce(f, op=op, group=group)
        return f.to(torch.bfloat16)
    torch.distributed.all_reduce(out, op=op, group=group)
    return out


def global_max(t: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the data axis (no gradient)."""
    g = data_group()
    if g is None:
        return t
    return _all_reduce(t, torch.distributed.ReduceOp.MAX, g)


def global_sum_int64(t: torch.Tensor) -> torch.Tensor:
    """The exact sum of an int64 tensor over the data axis, in place."""
    g = data_group()
    if g is None:
        return t
    if t.dtype != torch.int64:
        raise TypeError(f"global_sum_int64 takes int64, got {t.dtype}")
    torch.distributed.all_reduce(t, group=g)
    return t


def int64_reducer() -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """:func:`global_sum_int64` where a mesh reduces, else ``None``: the
    ``reduce`` argument of the PSG weight-gradient wrappers."""
    return None if data_group() is None else global_sum_int64


class _AllReduceSum(torch.autograd.Function):
    """Sum over the data axis; its backward sums the gradients likewise
    (every rank's objective depends on every rank's part)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, torch.distributed.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce(gy, torch.distributed.ReduceOp.SUM,
                           ctx.group), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the data axis, differentiable."""
    g = data_group()
    if g is None:
        return t
    return _AllReduceSum.apply(t, g)


def global_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x.mean(dim)`` over the global batch: the ranks' sums over ``dim``
    summed, over the global count (every rank holds as many rows)."""
    g = data_group()
    if g is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    s = x.sum() if dim is None else x.sum(dim=dim)
    n = x.numel() // max(s.numel(), 1) * torch.distributed.get_world_size(g)
    return global_sum(s) / n


def global_amax(x: torch.Tensor) -> Optional[torch.Tensor]:
    """``max|x|`` over the global batch (fp32 0-d) for a rank-local ``x``
    where a mesh reduces, else ``None`` (the caller's own ``amax``)."""
    if data_group() is None:
        return None
    return global_max(x.float().abs().amax())
