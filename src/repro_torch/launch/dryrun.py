"""Multi-pod dry run (the JAX package's ``launch/dryrun.py``).

For every (architecture x input-shape) cell, builds the production mesh
(single-pod ``16x16`` or multi-pod ``2x16x16``) over a world of fake ranks,
places the cell's state and inputs as ``DTensor``s by the sharding rules,
runs the real train step / prefill / decode step once on ``meta`` shards
(shapes and dtypes, no storage, no compute), and records rank 0's local
program:

* its memory: the arguments' local bytes and the peak of the live bytes
  while it runs (``bytes_per_device``), which proves the cell fits one
  card;
* its FLOPs and bytes (the local shards' ops, counted by the rules of
  ``analysis/op_cost``; every op's inputs and output as bytes moved), for
  the roofline priced for the H100 (``core/energy.roofline_terms``);
* its collectives: the result payloads of the collectives ``DTensor``
  issues, under the JAX package's five kind names.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out results.json

How it maps the JAX package's:

* **The world** lives only inside :func:`build_cell`: a fake process group
  (``torch.testing._internal.distributed.fake_pg``) of 256 (512) ranks,
  this process rank 0, whose collectives move nothing; it is torn down
  before the call returns, so ``dist.is_initialized()`` is as it was.
* **The program** runs on ``DTensor``s whose local shards are ``meta``
  tensors inside ``sharding.activation_sharding(mesh, spmd=True)``, where the
  models' ``hint``/``hint_batch`` sites pin the activations to the JAX
  package's logical specs and ``DTensor`` partitions every op, as XLA's
  SPMD partitioner does for the compiled program.
* **Kernels.** The PSG ops run on the dispatch layer's ``plain`` backend
  (``PSGConfig.backend``, written in the record as ``psg_backend``), the
  counterpart of the JAX package's dry run pricing its Pallas kernels in
  interpret mode: a ``meta`` tensor cannot launch a kernel, and a kernel's
  work is never counted as 0.
* **Per device** is rank 0's local program.  A dispatch mode above
  ``DTensor`` sees the global ops; the counter here lets ``DTensor`` run
  first and counts the local ops it issues.  Every loop is a Python loop
  that runs, so every trip is counted: the two keys that name XLA's
  body-once counts (``xla_cost_analysis_flops_body_once``,
  ``collectives_body_once``) carry the port's totals.
* **Memory**: ``argument`` is the local bytes of the inputs, ``output``
  those of what the step returns (the train and decode steps update their
  state in place: those bytes are ``alias``), ``peak`` the most bytes live
  at once (arguments included), and ``temp = peak - argument - (output -
  alias)``, so that ``peak = argument + temp + output - alias`` as in the
  JAX package's record.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs import ARCH_IDS, get_experiment
from repro_torch.core.config import SHAPES, shape_applicable
from repro_torch.core.energy import (H100_SXM, model_flops_6nd,
                                     model_fwd_flops, roofline_terms,
                                     train_step_flops)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as sp

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
PSG_BACKEND = "plain"


def collective_kind(name: str) -> Optional[str]:
    """The JAX package's kind name of a functional collective op (its
    schema name ``_c10d_functional::*``), or ``None`` for any other op
    (``wait_tensor`` included: it moves nothing)."""
    if not name.startswith("_c10d_functional::") or "wait" in name:
        return None
    for key, kind in (("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("broadcast", "collective-permute"),
                      ("permute", "collective-permute")):
        if key in name:
            return kind
    return None


# ---------------------------------------------------------------------------
# the world and the placements
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for the
    duration of the context; refused inside a process group of the
    caller's."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run builds its own world of fake ranks; "
                           "this process is in a process group already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_shape(shape, placements, mesh) -> List[int]:
    """Rank 0's shard of ``shape``: ``ceil(dim / n)`` along each mesh
    dimension that shards it (``torch.chunk``'s first chunk)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(m))
    return out


def place(t: torch.Tensor, placements, mesh, device, fill=None):
    """The ``DTensor`` of global shape ``t.shape`` and dtype ``t.dtype``
    whose rank-0 shard is a new tensor on ``device`` (``meta`` in the dry
    run); ``fill(local)`` sets its values where the program runs for
    real."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(local_shape(t.shape, placements, mesh),
                        dtype=t.dtype, device=device)
    if fill is not None:
        fill(local)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _owner(model: nn.Module, name: str):
    owner, _, leaf = name.rpartition(".")
    return (model.get_submodule(owner) if owner else model), leaf


def place_model(model: nn.Module, mesh, fsdp: bool, device, fill=None
                ) -> Dict[str, Any]:
    """Each parameter and buffer of the ``meta`` ``model`` as a
    ``DTensor`` placed by ``sharding.param_shardings`` (buffers
    replicated); returns the parameters' placements."""
    from torch.distributed.tensor import Replicate
    pl = shd.param_shardings(model, mesh, fsdp)
    for name, p in list(model.named_parameters()):
        mod, leaf = _owner(model, name)
        setattr(mod, leaf, nn.Parameter(place(p, pl[name], mesh, device,
                                              fill),
                                        requires_grad=p.requires_grad))
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    for name, b in list(model.named_buffers()):
        mod, leaf = _owner(model, name)
        mod._buffers[leaf] = place(b, rep, mesh, device, fill)
    return pl


def place_state(state, mesh, fsdp: bool, device, fill=None) -> None:
    """A ``meta`` ``TrainState`` placed in place: the model's leaves by
    :func:`place_model`, each optimizer and SWA dict of named tensors as
    its parameters are (``sharding.state_shardings``)."""
    pl = place_model(state.model, mesh, fsdp, device, fill)
    for d in (state.opt, state.swa or {}):
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = {n: place(t, pl[n], mesh, device, fill)
                        for n, t in v.items()}


def place_batch(batch: Dict[str, torch.Tensor], mesh, device, fill=None
                ) -> Dict[str, Any]:
    specs = shd.batch_sharding(mesh, batch)
    return {k: place(v, shd.placements(specs[k], mesh), mesh, device,
                     fill) for k, v in batch.items()}


def place_tree(tree, specs, mesh, device, fill=None):
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh, device, fill)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, s, mesh, device, fill)
                          for v, s in zip(tree, specs))
    return place(tree, shd.placements(specs, mesh), mesh, device, fill)


def local_tensors(obj) -> List[torch.Tensor]:
    """The local shards (or plain tensors) of every tensor in ``obj`` (a
    tree of dicts, lists, tuples, modules and ``TrainState``s)."""
    from torch.distributed.tensor import DTensor
    out: List[torch.Tensor] = []

    def walk(o):
        if isinstance(o, DTensor):
            out.append(o._local_tensor)
        elif isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, nn.Module):
            for t in o.parameters():
                walk(t)
            for t in o.buffers():
                walk(t)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
    walk(obj)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(obj) -> List[torch.Tensor]:
    """The tensors of an op's output or arguments (one level of lists)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    out: List[torch.Tensor] = []
    for o in obj if isinstance(obj, (tuple, list, type({}.values()))) \
            else ():
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (tuple, list)):
            out.extend(t for t in o if isinstance(t, torch.Tensor))
    return out


@functools.lru_cache(maxsize=None)
def _kind(func) -> Optional[str]:
    """A collective's kind; ``""`` for the functional collectives' other
    ops (``wait_tensor``, ``_wrap_tensor_autograd``), which move and
    allocate nothing on a card (on ``meta`` the wrap makes a new
    storage); ``None`` for any other op."""
    name = str(func.name())
    kind = collective_kind(name)
    return "" if kind is None and name.startswith("_c10d_functional::") \
        else kind


@functools.lru_cache(maxsize=None)
def _inplace(func) -> bool:
    from repro_torch.analysis.op_cost import op_name
    return op_name(func) != func.overloadpacket.__name__


def _storage_bytes(ts: List[torch.Tensor]) -> int:
    seen, n = set(), 0
    for t in ts:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


# ---------------------------------------------------------------------------
# rank 0's local program: its ops, collectives and live bytes
# ---------------------------------------------------------------------------


_STRICT_VIEWS = frozenset({torch.ops.aten.view.default,
                           torch.ops.aten._unsafe_view.default})


def _view_or_copy(func, args, kwargs):
    """A view of a ``DTensor``, or, where its sharding cannot be viewed to
    the new shape (a sharded dimension split or merged unevenly), the view
    of a resharded copy: its placements other than a shard of dimension 0
    replicated (all of them if that is not enough), the copy XLA's
    partitioner makes around such a reshape."""
    from torch.distributed.tensor import Replicate, Shard
    x, rest = args[0], args[1:]
    # a strided shard (a flattened pair of sharded dimensions) is resharded
    # first: DTensor views one to the wrong local shape
    if not any(type(p).__name__ == "_StridedShard" for p in x.placements):
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if "flatten" not in str(e):
                raise
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]
    try:
        return func(x.redistribute(x.device_mesh, rows), *rest, **kwargs)
    except RuntimeError as e:
        if "flatten" not in str(e):
            raise
    whole = [Replicate()] * x.device_mesh.ndim
    return func(x.redistribute(x.device_mesh, whole), *rest, **kwargs)


class SpmdViews:
    """The dispatch mode a program on ``DTensor``s runs under here: a
    strict view of a ``DTensor`` goes through :func:`_view_or_copy`, any
    other op of one to ``DTensor`` (which then issues the local ops), and
    a local op runs (:meth:`local`: nothing recorded)."""

    def local(self, func, args, kwargs):
        return func(*args, **kwargs)

    @contextlib.contextmanager
    def mode(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        owner = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    if func in _STRICT_VIEWS:
                        return _view_or_copy(func, args, kwargs)
                    return NotImplemented
                return owner.local(func, args, kwargs)

        with _Mode():
            yield self


class LocalProgram(SpmdViews):
    """Counts rank 0's local program: the ops ``DTensor`` issues on the
    local shards (a dispatch mode that lets ``DTensor`` run first), not the
    global ops above it, nor the shape propagation ``DTensor`` runs on
    fake tensors of the global shapes to learn an op's output.  A storage
    is live from the op that made it until it is freed."""

    def __init__(self):
        from repro_torch.analysis.op_cost import OpCounts
        self.ops = OpCounts()
        self.bytes = 0.0
        self.coll = {c: 0.0 for c in COLLECTIVES}
        self.coll["count"] = 0
        self.live = 0
        self.peak = 0
        self.suspended = 0

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until it is freed (once)."""
        st = t.untyped_storage()
        if getattr(st, "_dryrun_live", False):
            return
        st._dryrun_live = True
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def record(self, func, args, kwargs, out) -> None:
        from repro_torch.analysis.op_cost import count_op
        if func.is_view:
            return
        outs = _flat(out)
        if not outs:
            return
        kind = _kind(func)
        if kind == "":
            return
        if kind is not None:
            self.coll[kind] += float(sum(_nbytes(t) for t in outs))
            self.coll["count"] += 1
            for t in outs:
                self.track(t)
            return
        ins = _flat(args) + _flat(kwargs.values())
        cdata = {t.untyped_storage()._cdata for t in ins}
        if not _inplace(func) and any(t.untyped_storage()._cdata in cdata
                                      for t in outs):
            return                  # returned an input (a no-op copy)
        count_op(self.ops, func, args, out, False)
        self.bytes += float(sum(_nbytes(t) for t in ins) +
                            sum(_nbytes(t) for t in outs))
        for t in outs:
            self.track(t)

    def local(self, func, args, kwargs):
        out = func(*args, **kwargs)
        if not self.suspended:
            self.record(func, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def counting(self):
        """Count inside the context (``DTensor``'s shape propagation
        suspended)."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        prog = self
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(sp_self, *a, **kw):
            prog.suspended += 1
            try:
                return orig(sp_self, *a, **kw)
            finally:
                prog.suspended -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        try:
            with self.mode():
                yield self
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def collectives(self) -> Dict[str, float]:
        out = dict(self.coll)
        out["total"] = sum(self.coll[c] for c in COLLECTIVES)
        return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _dryrun_experiment(arch: str, shape: str, exp=None):
    exp = (exp or get_experiment(arch)).with_shape(shape)
    psg = dataclasses.replace(exp.e2.psg, backend=PSG_BACKEND)
    return exp.replace(e2=dataclasses.replace(exp.e2, psg=psg))


def _step_inputs(exp, shape: str, mesh, device, fill=None):
    """``(fn, args, arguments, returned)``: the cell's step, its placed
    arguments, and callables that give the tensors it reads and returns."""
    from repro_torch.serving.engine import make_decode_step, \
        make_prefill_step
    from repro_torch.training.train_step import make_train_step
    kind = SHAPES[shape]["kind"]
    specs = sp.input_specs(exp, shape)
    fsdp = exp.mesh.fsdp
    if kind == "train":
        state = specs["state"]
        place_state(state, mesh, fsdp, device, fill)
        batch = place_batch(specs["batch"], mesh, device, fill)
        step = make_train_step(exp)
        return (lambda: step(state, batch)), (state, batch)
    model = specs["params"]
    place_model(model, mesh, fsdp, device, fill)
    if kind == "prefill":
        tokens = place_batch({"tokens": specs["tokens"]}, mesh, device, fill)
        args = [model, tokens["tokens"]]
        if "frontend" in specs:
            args.append(place_batch({"f": specs["frontend"]}, mesh, device,
                                    fill)["f"])
        step = make_prefill_step(exp)
        return (lambda: step(*args)), tuple(args)
    state = place_tree(specs["state"],
                       shd.decode_state_shardings(specs["state"], mesh),
                       mesh, device, fill)
    token = place_batch({"t": specs["token"]}, mesh, device, fill)["t"]
    args = [model, token, state]
    if "memory" in specs:
        args.append(place_batch({"m": specs["memory"]}, mesh, device,
                                fill)["m"])
    step = make_decode_step(exp)
    return (lambda: step(*args)), tuple(args)


@contextlib.contextmanager
def cell_world(multi_pod: bool, device_type: str = "cpu"):
    """The fake world of a production mesh and the mesh over it."""
    from repro_torch.launch.mesh import make_production_mesh
    with fake_world(512 if multi_pod else 256):
        yield make_production_mesh(multi_pod=multi_pod,
                                   device_type=device_type)


def build_cell(arch: str, shape: str, multi_pod: bool, exp=None):
    """Run one cell's step once on ``meta`` shards; returns ``(program,
    exp, mesh_size, argument_bytes, output_bytes, alias_bytes)``.  ``exp``
    replaces ``arch``'s production experiment (a reduced one in tests)."""
    from torch.distributed.tensor.experimental import implicit_replication
    exp = _dryrun_experiment(arch, shape, exp)
    prog = LocalProgram()
    with cell_world(multi_pod) as mesh:
        chips = mesh.size()
        fn, args = _step_inputs(exp, shape, mesh, "meta")
        arguments = local_tensors(args)
        arg_bytes = _storage_bytes(arguments)
        arg_cdata = {t.untyped_storage()._cdata for t in arguments}
        with shd.activation_sharding(mesh, spmd=True), \
                implicit_replication(), prog.counting():
            for t in arguments:
                prog.track(t)
            out = fn()
        returned = local_tensors(out)
        out_bytes = _storage_bytes(returned)
        alias = _storage_bytes([t for t in returned
                                if t.untyped_storage()._cdata in arg_cdata])
        del out, returned, arguments, args, fn
    return prog, exp, chips, arg_bytes, out_bytes, alias


def _fill(t: torch.Tensor) -> None:
    """Values for a shard the program runs on for real: small normals for
    floats, zeros for integers (token 0, position 0)."""
    if t.is_floating_point():
        t.normal_(0.0, 0.02)
    else:
        t.zero_()


@contextlib.contextmanager
def card_program(arch: str, shape: str):
    """Rank 0's local program of ``arch``'s ``shape`` cell on the
    ``16x16`` mesh, for real on the card: the dry run's fake world and
    placements, its shards CUDA tensors (small normals, zero tokens); the
    fake group's collectives move nothing.  Yields a callable that runs
    the step once (under :class:`SpmdViews`, which records nothing)."""
    from torch.distributed.tensor.experimental import implicit_replication
    exp = _dryrun_experiment(arch, shape)
    with cell_world(False, "cuda") as mesh:
        fn, args = _step_inputs(exp, shape, mesh, torch.device("cuda"),
                                _fill)
        with shd.activation_sharding(mesh, spmd=True), \
                implicit_replication(), SpmdViews().mode():
            yield fn
        del fn, args


def analyze_cell(arch: str, shape: str, multi_pod: bool,
                 exp=None) -> Dict[str, Any]:
    """One cell's record (the module doc); ``exp`` replaces ``arch``'s
    production experiment."""
    t0 = time.time()
    exp = exp or get_experiment(arch)
    ok, why = shape_applicable(exp.model, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    try:
        prog, exp, chips, arg, out, alias = build_cell(arch, shape,
                                                        multi_pod, exp)
    except Exception as e:  # noqa: BLE001  (an error cell, not a crash)
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    kind = SHAPES[shape]["kind"]
    scfg = exp.serve
    if kind == "train":
        B, S = exp.train.global_batch, exp.train.seq_len
        mflops = model_flops_6nd(exp.model, B, S)
        ana_flops = train_step_flops(exp.model, B, S)
    elif kind == "prefill":
        B, S = scfg.batch, scfg.prefill_len
        mflops = model_flops_6nd(exp.model, B, S) / 3.0   # fwd only: 2ND
        ana_flops = model_fwd_flops(exp.model, B, S)
    else:
        B = scfg.batch
        mflops = model_flops_6nd(exp.model, B, 1) / 3.0
        ana_flops = model_fwd_flops(exp.model, B, 1, kv_len=scfg.max_kv_len)
    flops = prog.ops.flops()
    coll = prog.collectives()
    peak = prog.peak
    terms = roofline_terms(flops, prog.bytes, coll["total"], 1, hw=H100_SXM)
    return {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "status": "ok",
        "chips": chips,
        "params": exp.model.param_count(),
        "active_params": exp.model.active_param_count(),
        "bytes_per_device": {
            "argument": arg, "output": out,
            "temp": peak - arg - (out - alias), "alias": alias,
            "peak": peak,
        },
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": prog.bytes,
        "collective_bytes_per_device": coll["total"],
        "xla_cost_analysis_flops_body_once": flops,
        "model_flops_6nd": mflops,
        "analytic_flops": ana_flops,
        "useful_ratio": (mflops / chips / flops) if flops else 0.0,
        "collectives_body_once": coll,
        "roofline": terms,
        "psg_backend": PSG_BACKEND,
        "compile_s": time.time() - t0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                r = analyze_cell(arch, shape, mp)
                results.append(r)
                status = r["status"]
                extra = ""
                if status == "ok":
                    bl = r["roofline"]["bottleneck"]
                    pk = r["bytes_per_device"]["peak"] / 2**30
                    extra = (f"peak={pk:.2f}GiB "
                             f"step={r['roofline']['step_s']*1e3:.2f}ms "
                             f"bound={bl} compile={r['compile_s']:.0f}s")
                elif status == "error":
                    extra = r["error"][:200]
                else:
                    extra = r["reason"][:80]
                print(f"[{'2x16x16' if mp else '16x16'}] {arch:20s} "
                      f"{shape:12s} {status:7s} {extra}", flush=True)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {len(results)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
