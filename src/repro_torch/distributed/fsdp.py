"""Parameters sharded between steps on a data-parallel mesh, as the JAX
package's ``state_shardings`` places them (``sharding.param_specs``).

Between steps each rank of a data axis of ``world > 1`` ranks holds only
its shard of every parameter the rules shard over ``data`` (FSDP), of its
optimizer moments and of its SWA average; a parameter the rules replicate
(every one of a CNN's) or whose FSDP dimension the axis does not divide
stays whole on every rank.  :meth:`DataParallel.place` shards a full
state in place and leaves a :class:`ModuleShards` on each module that owns
sharded parameters.  A step:

1. **forward**: each LM sub-block (``models/transformer.py``) runs under
   :func:`gathered`, which makes its modules' sharded parameters whole in
   one bucketed all-gather (:class:`_Gather`) and frees them when the
   sub-block ends; the tied embedding and head are made whole where they
   are used (:func:`whole`).  The gather sits inside the sub-block's
   checkpointed region, so no whole weight stays in autograd's saved
   tensors across the forward: the recompute gathers again.  With
   ``PSGConfig.int8_gather`` a PSG sub-block gathers no weight: each
   stays this rank's shard, marked (:func:`mark_shard`), and the PSG op
   all-gathers its int8 codes (:func:`int8_gather`);
2. **backward**: as soon as a sub-block's backward ends, the gradients of
   its whole weights are summed over the data axis in fp32 and each rank
   keeps its shard (:class:`_Gather`'s backward: one all-reduce and a
   narrow), so no rank ever holds every whole gradient; the replicated
   leaves' gradients are summed after the backward
   (:meth:`DataParallel.reduce_grads`);
3. **update**: the optimizer and SWA run on the shards as they are; no
   gather follows.

Per-sub-block gathers are collectives inside the forward, so every rank
must run the same ones in the same order.  They do: SLU's keep decision
compares the step's uniform, the same on every rank, with the gate's
probability of the global batch's pooled feature (``core/slu.Gate``), so
every rank skips the same sub-blocks, and a skipped one gathers nothing
on any rank.  A gather that fails or times out raises, under the group's
timeout, and ends the world; nothing runs on a stale or partial weight.

:meth:`DataParallel.full_state` gathers the whole state (parameters too)
into the full logical arrays that checkpoints hold, and ``ft/elastic``'s
``reshard_state`` places a full state on a mesh.  :data:`STATS` counts what
the gathers did: the whole-weight bytes they made and that are alive, the
peak of those, the bytes received by dtype, the fp32 bytes all-reduced.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.quant import qscale, round_codes
from repro_torch.distributed import sharding

_INFO = "_fsdp_shards"          # a module's ModuleShards
_ROOT = "_fsdp_placement"       # a placed model's Placement
_MARK = "_fsdp_shard"           # (dim, Placement) of a marked shard


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class Placement:
    """The data axis a model's shards live on: its group, its size and
    this rank.  A copy of a placed model shares it."""

    def __init__(self, group):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __deepcopy__(self, memo):
        return self

    def narrow(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard of the whole ``t`` along ``dim`` (a view)."""
        n = t.shape[dim] // self.world
        return t.narrow(dim, self.rank * n, n)


class ModuleShards:
    """What :meth:`DataParallel.place` leaves on a module that owns
    sharded parameters: each one's dimension and whole shape by local
    name, the placement, and the module's qualified name (for logs)."""

    def __init__(self, dims: Dict[str, int], shapes: Dict[str, torch.Size],
                 placement: Placement, prefix: str):
        self.dims, self.shapes = dims, shapes
        self.placement, self.prefix = placement, prefix

    def label(self, name: str) -> str:
        """The qualified name of the module's parameter ``name``."""
        return f"{self.prefix}.{name}" if self.prefix else name


class GatherStats:
    """What the step's gathers did since :meth:`reset` (the state's, for a
    checkpoint, are not counted): ``live`` whole-weight
    bytes they made that are still allocated (each freed storage
    subtracts its bytes), their ``peak``, ``gathers`` calls, ``wire``
    bytes received from the other ranks by dtype, ``reduced`` fp32 bytes
    all-reduced by the backward, and, while ``log`` is a list, the
    qualified names each gather made whole (``int8:`` before a weight
    whose codes were gathered)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.live = 0
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.peak = self.live
            self.gathers = 0
            self.wire: Dict[str, int] = collections.Counter()
            self.reduced = 0
            self.log: Optional[List[List[str]]] = None

    def track(self, t: torch.Tensor) -> None:
        n = t.untyped_storage().nbytes()
        with self._lock:
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(t.untyped_storage(), self._freed, n)

    def _freed(self, n: int) -> None:
        with self._lock:
            self.live -= n

    def reduced_bytes(self, n: int) -> None:
        with self._lock:
            self.reduced += n

    def record(self, names: Sequence[str], received: Dict[str, int]
               ) -> None:
        with self._lock:
            self.gathers += 1
            for k, v in received.items():
                self.wire[k] += v
            if self.log is not None and names:
                self.log.append(list(names))


STATS = GatherStats()


def _all_gather(shards: Sequence[torch.Tensor], dims: Sequence[int],
                plc: Placement, names: Sequence[str] = (),
                record: bool = True) -> List[torch.Tensor]:
    """Whole tensors from every rank's shards, in one all-gather of their
    bytes; with ``record``, recorded in :data:`STATS` (under ``names`` in
    its log)."""
    if not shards:
        return []
    parts = []
    for s in shards:
        b = s.contiguous().reshape(-1).view(torch.uint8)
        pad = _pad8(b.numel()) - b.numel()
        parts.append(torch.cat([b, b.new_zeros(pad)]) if pad else b)
    buf = torch.cat(parts)
    outs = [torch.empty_like(buf) for _ in range(plc.world)]
    dist.all_gather(outs, buf, group=plc.group)
    wholes, off = [], 0
    received: Dict[str, int] = collections.Counter()
    for s, d in zip(shards, dims):
        nb = s.numel() * s.element_size()
        pieces = [o[off:off + nb].view(s.dtype).reshape(s.shape)
                  for o in outs]
        wholes.append(torch.cat(pieces, dim=d))
        received[str(s.dtype).replace("torch.", "")] += \
            nb * (plc.world - 1)
        off += _pad8(nb)
    if record:
        STATS.record(names, received)
    return wholes


def _sum_to_shards(grads: Sequence[torch.Tensor], dims: Sequence[int],
                   plc: Placement) -> List[torch.Tensor]:
    """Whole gradients summed over the data axis in one fp32 all-reduce;
    this rank's shard of each, a tensor of its own in the gradient's
    dtype."""
    flat = torch.cat([g.float().reshape(-1) for g in grads])
    dist.all_reduce(flat, group=plc.group)
    STATS.reduced_bytes(flat.numel() * flat.element_size())
    out, off = [], 0
    for g, d in zip(grads, dims):
        whole = flat[off:off + g.numel()].view(g.shape)
        out.append(plc.narrow(whole, d).to(g.dtype).clone(
            memory_format=torch.contiguous_format))
        off += g.numel()
    return out


class _Gather(torch.autograd.Function):
    """Shards -> whole tensors (one bucketed all-gather, each whole
    tracked in :data:`STATS`); the backward sums each whole's gradient
    over the data axis and returns this rank's shard of it."""

    @staticmethod
    def forward(ctx, how, *shards):
        dims, plc, names = how
        ctx.dims, ctx.plc = dims, plc
        wholes = _all_gather(shards, dims, plc, names)
        for w in wholes:
            STATS.track(w)
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_sum_to_shards(grads, ctx.dims, ctx.plc))


def mark_shard(t: torch.Tensor, dim: int, plc: Placement) -> torch.Tensor:
    """Mark ``t`` as this rank's shard along ``dim`` of a weight the PSG
    ops gather as int8 codes (:func:`shard_of`); returns ``t``."""
    setattr(t, _MARK, (dim, plc))
    return t


def shard_of(t: torch.Tensor) -> Optional[Tuple[int, Placement]]:
    """``(dim, placement)`` of a marked shard (:func:`mark_shard`), else
    ``None``: a whole weight."""
    return getattr(t, _MARK, None)


def int8_gather(w: torch.Tensor, dim: int, plc: Placement, bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``PSGConfig.int8_gather``: the whole weight's int8 codes and fp32
    scale from this rank's shard ``w`` along ``dim``.  Each rank quantizes
    its shard on the global grid (a MAX all-reduce of the shards'
    ``max|w|``), and the ranks all-gather the codes, so they equal
    ``codes(whole, bits)`` bit for bit and no fp32 weight crosses the
    wire."""
    if bits > 8:
        raise ValueError(f"int8_gather: {bits}-bit codes are not int8")
    amax = w.float().abs().amax()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=plc.group)
    s = qscale(w, bits, amax=amax)
    c = round_codes(w, s, bits).to(torch.int8)
    whole, = _all_gather([c], [dim], plc)
    STATS.track(whole)
    return whole, s


def _entries(modules: Sequence[nn.Module]):
    """``(module, local name, dim, info)`` of every sharded parameter the
    modules (and their children) own."""
    return [(sub, n, d, info) for m in modules for sub in m.modules()
            if (info := sub.__dict__.get(_INFO)) is not None
            for n, d in info.dims.items()]


@contextlib.contextmanager
def gathered(modules: Sequence[nn.Module],
             cast: Optional[torch.dtype] = None):
    """Inside, every sharded parameter of ``modules`` is whole (one
    bucketed all-gather, differentiable: :class:`_Gather`); on exit the
    modules hold their shards again and the wholes are the caller's
    autograd graph's alone.  With ``cast`` (``int8_gather`` on a PSG
    sub-block, whose every sharded weight feeds a PSG op) nothing is
    gathered: each parameter becomes its shard cast to ``cast`` (the
    activation dtype, which the layers' ``.to(dtype)`` then leaves as it
    is) and marked for the PSG op (:func:`mark_shard`).  A no-op for
    modules with no sharded parameter."""
    entries = _entries(modules)
    if not entries:
        yield
        return
    plc = entries[0][3].placement
    shards = [sub._parameters[n] for sub, n, _, _ in entries]
    if cast is None:
        names = [i.label(n) for _, n, _, i in entries]
        new = _Gather.apply(([d for _, _, d, _ in entries], plc, names),
                            *shards)
    else:
        if STATS.log is not None:
            STATS.log.append([f"int8:{i.label(n)}" for _, n, _, i in entries])
        new = [mark_shard(s.to(cast) if s.dtype != cast else s.view_as(s),
                          d, plc)
               for s, (_, _, d, _) in zip(shards, entries)]
    try:
        for (sub, n, _, _), t in zip(entries, new):
            sub._parameters[n] = t
        del new
        yield
    finally:
        for (sub, n, _, _), s in zip(entries, shards):
            sub._parameters[n] = s


def whole(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name``, made whole by a differentiable
    gather if it is sharded (the tied embedding and head, at each use)."""
    p = getattr(module, name)
    info = module.__dict__.get(_INFO)
    if info is None or name not in info.dims:
        return p
    return _Gather.apply(((info.dims[name],), info.placement,
                          (info.label(name),)), p)[0]


def is_sharded(model: nn.Module) -> bool:
    """Whether ``model`` was placed with sharded parameters."""
    return model.__dict__.get(_ROOT) is not None


class DataParallel:
    """One rank's view of a mesh whose data axis has ``world > 1`` ranks;
    ``model``'s parameter names and whole shapes (also once placed) fix
    which are sharded."""

    def __init__(self, mesh, model: nn.Module, fsdp: bool = True):
        self.mesh = mesh
        self.group = mesh.get_group("data")
        self.placement = Placement(self.group)
        self.world, self.rank = self.placement.world, self.placement.rank
        named = whole_shapes(model)
        specs = sharding.param_specs(named, mesh, fsdp,
                                     getattr(model, "unit", None))
        self.dims: Dict[str, Optional[int]] = {
            k: sharding.shard_dim(s) for k, s in specs.items()}
        self.device = next(model.parameters()).device

    def sharded(self) -> List[str]:
        """The sharded parameters, in model order."""
        return [k for k, d in self.dims.items() if d is not None]

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole ``t`` (a view), or ``t`` if
        replicated."""
        d = self.dims.get(name)
        return t if d is None else self.placement.narrow(t, d)

    # -- the step ---------------------------------------------------------

    def reduce_grads(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The replicated leaves' gradients summed over the data axis in
        one fp32 all-reduce (each rank's are of its rows' share of the
        loss); the sharded ones, summed in the backward, as they are."""
        names = [k for k in grads if self.dims.get(k) is None]
        if not names:
            return grads
        flat = torch.cat([grads[k].float().reshape(-1) for k in names])
        dist.all_reduce(flat, group=self.group)
        out, off = dict(grads), 0
        for k in names:
            g = grads[k]
            out[k] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
            off += g.numel()
        return out

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global gradient's norm: the shards' squared sums,
        all-reduced, plus each replicated leaf's once."""
        zero = torch.zeros((), device=self.device)
        sq = sum((torch.sum(g.float() ** 2) for k, g in grads.items()
                  if self.dims.get(k) is not None), zero)
        dist.all_reduce(sq, group=self.group)
        return torch.sqrt(sq + sum((torch.sum(g.float() ** 2)
                                    for k, g in grads.items()
                                    if self.dims.get(k) is None), zero))

    # -- the state --------------------------------------------------------

    @torch.no_grad()
    def place(self, state):
        """Shard a full state in place: each sharded parameter, its
        moments and its SWA average become this rank's shard (tensors of
        their own), and each module owning sharded parameters gets its
        :class:`ModuleShards`."""
        model = state.model
        for prefix, mod in model.named_modules():
            dims, shapes = {}, {}
            for n, p in mod.named_parameters(recurse=False):
                d = self.dims.get(f"{prefix}.{n}" if prefix else n)
                if d is not None:
                    dims[n], shapes[n] = d, p.shape
                    p.data = self.placement.narrow(p.data, d).clone(
                        memory_format=torch.contiguous_format)
            if dims:
                mod.__dict__[_INFO] = ModuleShards(dims, shapes,
                                                   self.placement, prefix)
        if self.sharded():
            model.__dict__[_ROOT] = self.placement
        for d in (state.opt, state.swa or {}):
            for k, v in d.items():
                if isinstance(v, dict):
                    d[k] = {n: self.shard(n, t).clone(
                        memory_format=torch.contiguous_format)
                        for n, t in v.items()}
        state.mesh = self.mesh
        return state

    def _gather_state(self, named: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        keys = [k for k in named if self.dims.get(k) is not None]
        return dict(zip(keys, _all_gather([named[k] for k in keys],
                                          [self.dims[k] for k in keys],
                                          self.placement, record=False)))

    @torch.no_grad()
    def full_state(self, state):
        """A ``TrainState`` of the full logical arrays for a checkpoint or
        a reshard: a copy of the model with its parameters gathered whole
        (the model itself where none is sharded), the optimizer and SWA
        state gathered, the step the same; every rank must call it."""
        from repro_torch.training.train_step import TrainState
        model = state.model
        if is_sharded(model):
            model = copy.deepcopy(model)
            fulls = self._gather_state(dict(model.named_parameters()))
            for k, p in model.named_parameters():
                if k in fulls:
                    p.data = fulls[k]
            for mod in model.modules():
                mod.__dict__.pop(_INFO, None)
            model.__dict__.pop(_ROOT, None)

        def full(d):
            if d is None:
                return None
            return {k: ({**v, **self._gather_state(v)}
                        if isinstance(v, dict) else v)
                    for k, v in d.items()}

        return TrainState(model, full(state.opt), full(state.swa),
                          state.step)

    def all_max(self, value: float) -> float:
        """The max of a host number over the data axis."""
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t[0])


def whole_shapes(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter as a ``meta`` tensor of its whole shape, by
    qualified name, a placed model's too."""
    out = {}
    for prefix, mod in model.named_modules():
        info = mod.__dict__.get(_INFO)
        for n, p in mod.named_parameters(recurse=False):
            k = f"{prefix}.{n}" if prefix else n
            shape = info.shapes[n] if info and n in info.shapes else p.shape
            out[k] = torch.empty(shape, device="meta")
    return out
