"""Precision provenance over dispatched ATen ops.

The counterpart of the JAX package's ``analysis/dataflow.py``, an abstract
interpreter over jaxprs.  Here :func:`analyze` runs the program under a
``TorchDispatchMode`` (:class:`DataflowMode`) that carries a small
lattice per value through every op it dispatches:

* **narrow** — the set of sub-32-bit dtypes anywhere in the value's
  lineage (``bfloat16``/``float16``/fp8/``int8``/``int16``/...).
  Upcasting does *not* clear it: a value that was ever bf16 stays
  bf16-descended.
* **depth** — how many reductions the value has passed through.
* **chain** — the length of the current run of additive ops, which
  recognizes an unrolled accumulation (``acc = acc + tap`` k² times, or
  ``acc += tap`` in place) without flagging every residual add.
* **origin** — where narrowness first entered the lineage.

The program runs eagerly, so there are no loop carries or kernel refs to
tag: a loop is its unrolled ops, and an in-place accumulation is a chain
on the accumulator's storage.  Values are keyed by their storage, so a
view shares its base's lattice and an in-place write through a view
reaches the base; a fresh output replaces whatever a freed storage at the
same address held.

Every reduction is recorded as a :class:`ReductionSite` with its
**accumulator dtype** (the output's, where the partial sums live):

=================  ========================================================
kind               emitted for
=================  ========================================================
``dot_general``    ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (einsum, ``@``)
``conv``           ``convolution``
``reduce_sum``     ``sum``, ``mean``, ``var``, the softmaxes, norms
``cumsum``         ``cumsum``
``scatter-add``    ``index_add``, ``scatter_add``, accumulating
                   ``index_put`` and the embedding's backward
``add-chain``      an additive run crossing :data:`ADD_CHAIN_SITE` ops
=================  ========================================================

:meth:`DataflowResult.hazards` returns the sites whose accumulator is
narrower than 32 bits while their operands descend from narrow values —
the bug class of the reference's conv dx backward, fixed there by hand.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, FrozenSet, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.op_cost import op_name
from repro_torch.core import cost

NARROW_DTYPES = frozenset({
    "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2",
    "float8_e4m3fnuz", "float8_e5m2fnuz", "int8", "uint8", "int16",
    "uint16", "int4", "uint4",
})
_ADDITIVE = frozenset({"add", "sub", "rsub"})
ADD_CHAIN_SITE = 3          # an additive run this long is an accumulation
_REDUCE_SITES = {
    "mm": "dot_general", "bmm": "dot_general", "addmm": "dot_general",
    "baddbmm": "dot_general", "addbmm": "dot_general", "mv": "dot_general",
    "addmv": "dot_general", "dot": "dot_general", "vdot": "dot_general",
    "convolution": "conv", "_convolution": "conv",
    "convolution_overrideable": "conv",
    "sum": "reduce_sum", "nansum": "reduce_sum", "mean": "reduce_sum",
    "var": "reduce_sum", "var_mean": "reduce_sum", "std": "reduce_sum",
    "std_mean": "reduce_sum", "_softmax": "reduce_sum",
    "_log_softmax": "reduce_sum", "linalg_vector_norm": "reduce_sum",
    "norm": "reduce_sum", "cumsum": "cumsum", "index_add": "scatter-add",
    "scatter_add": "scatter-add", "embedding_dense_backward": "scatter-add",
}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def acc_is_narrow(dtype: str) -> bool:
    """True when partial sums in this dtype lose low-order contributions
    (any float/int accumulator under 32 bits)."""
    if dtype in NARROW_DTYPES:
        return True
    try:
        dt = getattr(torch, dtype)
    except AttributeError:
        return False
    if not isinstance(dt, torch.dtype) or dt == torch.bool:
        return False
    return dt.itemsize < 4


@dataclass(frozen=True)
class Prov:
    """Per-value lattice element (see the module doc)."""

    narrow: FrozenSet[str] = frozenset()
    depth: int = 0
    chain: int = 0
    origin: str = ""


def join(*provs: Prov) -> Prov:
    narrow: FrozenSet[str] = frozenset()
    depth = chain = 0
    origin = ""
    for p in provs:
        narrow |= p.narrow
        depth = max(depth, p.depth)
        chain = max(chain, p.chain)
        if p.narrow and not origin:
            origin = p.origin
    return Prov(narrow, depth, chain, origin)


@dataclass(frozen=True)
class ReductionSite:
    """One reduction with the dtype its partial sums live in."""

    kind: str                           # see the module table
    prim: str                           # the ATen op
    site: str                           # program name / cost scope / op
    acc_dtype: str                      # accumulator dtype name
    narrow_operands: Tuple[str, ...]    # narrow dtypes in operand lineage
    depth: int
    origin: str                         # where narrowness entered, or ""

    def __str__(self) -> str:
        ops = ",".join(self.narrow_operands) or "wide"
        via = f" (narrow via {self.origin})" if self.origin else ""
        return (f"{self.site}: [{self.kind}] accumulates {ops} operands "
                f"in {self.acc_dtype}{via}")


@dataclass
class DataflowResult:
    sites: List[ReductionSite] = field(default_factory=list)

    def hazards(self) -> List[ReductionSite]:
        """Sites accumulating narrow-descended operands in a sub-32-bit
        accumulator."""
        return [s for s in self.sites
                if s.narrow_operands and acc_is_narrow(s.acc_dtype)]


def _key(t: torch.Tensor) -> Tuple[str, int]:
    return (t.device.type, t.untyped_storage().data_ptr())


class DataflowMode(TorchDispatchMode):
    """Carries :class:`Prov` through every dispatched op and records the
    reduction sites of the program ``name``."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.prov: Dict[Tuple[str, int], Prov] = {}
        self.sites: Dict[tuple, ReductionSite] = {}

    def _read(self, t: torch.Tensor) -> Prov:
        p = self.prov.get(_key(t), Prov())
        dt = dtype_name(t.dtype)
        if dt in NARROW_DTYPES and dt not in p.narrow:
            p = replace(p, narrow=p.narrow | {dt},
                        origin=p.origin or f"{self.name}:input:{dt}")
        return p

    def _site(self, kind: str, prim: str, where: str, acc: str,
              ops: Prov) -> None:
        key = (kind, prim, where, acc, tuple(sorted(ops.narrow)))
        if key not in self.sites:
            self.sites[key] = ReductionSite(
                kind, prim, where, acc, tuple(sorted(ops.narrow)),
                ops.depth, ops.origin)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        name = op_name(func)
        scope = cost.current_scope()
        where = f"{self.name}/{scope}/{name}" if scope \
            else f"{self.name}/{name}"
        ops = join(*(self._read(t) for t in ins)) if ins else Prov()
        acc = dtype_name(outs[0].dtype)
        accumulating = name == "index_put" and bool(
            kwargs.get("accumulate", args[3] if len(args) > 3 else False))
        if name in _REDUCE_SITES or accumulating:
            kind = _REDUCE_SITES.get(name, "scatter-add")
            self._site(kind, name, where, acc, ops)
            res = Prov(ops.narrow, ops.depth + 1, 0, ops.origin)
        elif name in _ADDITIVE:
            chain = ops.chain + 1
            if chain == ADD_CHAIN_SITE:
                self._site("add-chain", name, where, acc, ops)
            res = replace(ops, chain=chain)
        elif func.is_view:
            res = ops
        else:
            res = replace(ops, chain=0)
        for t in outs:
            self.prov[_key(t)] = res
        return out


def analyze(fn, *args, name: str = "program", **kwargs) -> DataflowResult:
    """Run ``fn(*args, **kwargs)`` under :class:`DataflowMode` and return
    its reduction sites (the cost scopes open at each op name the site)."""
    mode = DataflowMode(name)
    with cost.listening(), mode:
        fn(*args, **kwargs)
    return DataflowResult(sites=sorted(
        mode.sites.values(), key=lambda s: (s.site, s.kind, s.acc_dtype)))
