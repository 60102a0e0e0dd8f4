"""The train state of one rank of a data-parallel mesh, sharded by the
rule table (``sharding.param_specs``).

Each rank holds the whole model (the working copy its forward and
backward read) and, of every parameter the rules shard over ``data``
(FSDP), only its shard of the optimizer moments and of the SWA average; a
parameter whose FSDP dimension the data axis does not divide, and every
parameter the rules replicate (all of a CNN's), keeps its whole state on
every rank.  A step:

1. each rank's gradients of its rows, summed over the data axis in one
   bucketed all-reduce (:meth:`DataParallel.reduce_grads`; what FSDP's
   reduce-scatter computes, before each rank keeps its shard);
2. the optimizer and SWA update each rank's shard of each parameter
   (:meth:`DataParallel.update`), then one all-gather of the updated
   shards makes the working copy whole again on every rank.

A gather therefore runs once a step, outside the forward, on every rank,
so no gated block's gather can be skipped by one rank alone.
:meth:`DataParallel.full_state` gathers the sharded state into the full
logical arrays that checkpoints hold; :meth:`DataParallel.place` shards a
full state (``ft/elastic.reshard_state``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.quant import qscale, round_codes
from repro_torch.distributed import sharding


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class DataParallel:
    """One rank's view of a mesh whose data axis has ``world > 1`` ranks;
    ``model``'s parameter names and shapes fix which are sharded."""

    def __init__(self, mesh, model, fsdp: bool = True):
        self.mesh = mesh
        self.group = mesh.get_group("data")
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        named = dict(model.named_parameters())
        specs = sharding.param_specs(named, mesh, fsdp,
                                     getattr(model, "unit", None))
        self.dims: Dict[str, Optional[int]] = {
            k: sharding.shard_dim(s) for k, s in specs.items()}
        self.device = next(model.parameters()).device

    def sharded(self) -> List[str]:
        """The parameters whose state is sharded, in model order."""
        return [k for k, d in self.dims.items() if d is not None]

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``t`` (a view), or ``t`` if replicated."""
        d = self.dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // self.world
        return t.narrow(d, self.rank * n, n)

    # -- collectives of the state -----------------------------------------

    def _gather(self, shards: List[Tuple[str, torch.Tensor]]
                ) -> List[torch.Tensor]:
        """Whole tensors from every rank's shards, in one all-gather of
        their bytes."""
        if not shards:
            return []
        parts = []
        for _, s in shards:
            b = s.contiguous().reshape(-1).view(torch.uint8)
            pad = _pad8(b.numel()) - b.numel()
            parts.append(torch.cat([b, b.new_zeros(pad)]) if pad else b)
        buf = torch.cat(parts)
        outs = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(outs, buf, group=self.group)
        fulls, off = [], 0
        for name, s in shards:
            nb = s.numel() * s.element_size()
            pieces = [o[off:off + nb].view(s.dtype).reshape(s.shape)
                      for o in outs]
            fulls.append(torch.cat(pieces, dim=self.dims[name]))
            off += _pad8(nb)
        return fulls

    def reduce_grads(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Every gradient summed over the data axis, in one fp32
        all-reduce (each rank's are of its rows' share of the loss)."""
        names = list(grads)
        flat = torch.cat([grads[k].float().reshape(-1) for k in names])
        dist.all_reduce(flat, group=self.group)
        out, off = {}, 0
        for k in names:
            g = grads[k]
            out[k] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
            off += g.numel()
        return out

    @torch.no_grad()
    def gather_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Make each sharded parameter whole from the ranks' shards."""
        names = self.sharded()
        fulls = self._gather([(k, self.shard(k, params[k])) for k in names])
        for k, full in zip(names, fulls):
            params[k].copy_(full)

    @torch.no_grad()
    def update(self, opt, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], opt_state, scal,
               swa=None, swa_w=None) -> None:
        """The optimizer (and SWA) on this rank's shards, then the
        gather."""
        from repro_torch.optim.swa import swa_average
        sp = {k: self.shard(k, p) for k, p in params.items()}
        opt.update(sp, {k: self.shard(k, g) for k, g in grads.items()},
                   opt_state, scal)
        if swa is not None:
            swa_average(swa, sp, swa_w)
        self.gather_params(params)

    def place(self, state):
        """Shard a full state's optimizer and SWA dicts in place."""
        for d in (state.opt, state.swa or {}):
            for k, v in d.items():
                if isinstance(v, dict):
                    d[k] = {n: self.shard(n, t).clone(
                        memory_format=torch.contiguous_format)
                        for n, t in v.items()}
        state.mesh = self.mesh
        return state

    def full_state(self, state):
        """A ``TrainState`` of the full logical arrays (gathered; the model
        shared, the step the same) for a checkpoint or a reshard."""
        from repro_torch.training.train_step import TrainState

        def full(d):
            if d is None:
                return None
            keys = [(k, n) for k, v in d.items() if isinstance(v, dict)
                    for n in v if self.dims.get(n) is not None]
            fulls = dict(zip(keys, self._gather([(n, d[k][n])
                                                 for k, n in keys])))
            return {k: ({n: fulls.get((k, n), t) for n, t in v.items()}
                        if isinstance(v, dict) else v)
                    for k, v in d.items()}

        return TrainState(state.model, full(state.opt), full(state.swa),
                          state.step)

    def all_max(self, value: float) -> float:
        """The max of a host number over the data axis."""
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t[0])


def int8_gather(w: torch.Tensor, bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``PSGConfig.int8_gather``: a weight's int8 codes and fp32 scale with
    the gather on the codes.  Each rank quantizes its rows (dim 0) of
    ``w`` on the global grid (a MAX all-reduce of the rows' ``max|w|``),
    and the ranks all-gather the codes, so they equal ``codes(w, bits)``
    bit for bit.  Rows the data axis does not divide, and outside a mesh,
    quantize ``w`` whole."""
    from repro_torch.core.quant import codes
    g = sharding.data_group()
    if bits > 8:
        raise ValueError(f"int8_gather: {bits}-bit codes are not int8")
    if g is None or w.shape[0] % dist.get_world_size(g):
        return codes(w, bits)
    world, rank = dist.get_world_size(g), dist.get_rank(g)
    n = w.shape[0] // world
    rows = w.narrow(0, rank * n, n)
    s = qscale(rows, bits, amax=sharding.global_max(
        rows.float().abs().amax()))
    c = round_codes(rows, s, bits).to(torch.int8).contiguous()
    parts = [torch.empty_like(c) for _ in range(world)]
    dist.all_gather(parts, c, group=g)
    return torch.cat(parts), s
