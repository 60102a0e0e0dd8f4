"""Op counter: per-op FLOPs/bytes of a program, attributed to layer groups.

The counterpart of the JAX package's ``analysis/jaxpr_cost.py``.  Where
that module walks the traced jaxpr, :func:`op_costs` runs the program under
a ``TorchDispatchMode`` and counts every ATen op it dispatches, attributed
to the innermost ``core/cost.cost_scope`` open when the op ran (the
models' ``jax.named_scope("cost:<name>")`` anchors).  The program runs for
real, on the device of its inputs: loops are unrolled by running them, so
every trip count is the one executed and ``unknown_trips`` stays 0.

Counting semantics (the reference's; MACs are the currency of
``core/cost.py``):

* contractions ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (``torch.einsum``
  and ``@`` reach the dispatcher as these) — ``dot_macs`` = numel(out) x
  the contracted size;
* ``convolution`` — ``conv_macs`` = numel(out) x cin-per-group x the
  kernel's spatial size;
* patch extraction (``kernels/conv.conv_patches``, marked by
  ``core/cost.patch_extraction``) — ``gather_flops`` = numel of each
  materialized output, never MACs;
* ``mul`` — ``mul_flops`` (MobileNetV2's depthwise conv is nine explicit
  multiplies, ``addcmul`` counting one multiply and one add), so its MACs
  are the multiply count of its ``b{i}.dw`` scope;
* other elementwise ops — ``other_flops``, one per output element;
  reductions one per operand element; ``_softmax`` / ``_log_softmax`` five
  per element (the max and sum reductions, the subtraction, ``exp``, the
  division or ``log``);
* views, copies, casts, comparisons, selects and the indexing ops — free;
  any other op is charged its output bytes only, never silent compute.

A launch of one of the port's CUDA kernels goes through ``ctypes`` and is
invisible to a dispatch mode.  So the counter refuses to count one: the
kernel dispatch layer raises under it (``core/cost.refuse_if_counting``),
and a change of any kernel wrapper's launch count during the counted run
raises too.  A kernel's work is never counted as 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import cost

UNATTRIBUTED = ""

_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
                   "dot", "vdot"})
_CONVS = frozenset({"convolution", "_convolution", "convolution_overrideable",
                    "cudnn_convolution", "mkldnn_convolution"})
# elementwise ops that move or compare values rather than compute them
_FREE = frozenset({
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "where", "masked_fill", "isfinite",
    "isnan", "isinf", "_to_copy", "to", "copy", "clone", "fill", "zero",
    "lift_fresh", "lift_fresh_copy", "_assert_tensor_metadata", "cat",
    "stack", "constant_pad_nd", "index", "index_select", "gather",
    "embedding", "scatter", "index_put", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "arange", "scalar_tensor", "tril", "triu", "flip", "roll",
    "repeat", "contiguous", "detach", "_local_scalar_dense", "new_empty",
    "new_zeros", "new_ones", "new_full",
})
_SOFTMAX = frozenset({"_softmax", "_log_softmax", "softmax", "log_softmax"})
SOFTMAX_FLOPS = 5           # per element: max, subtract, exp, sum, divide


@dataclass
class OpCounts:
    """Operation counts of one attribution scope (or a whole program)."""

    dot_macs: float = 0.0       # mm / bmm / addmm contractions
    conv_macs: float = 0.0      # real convolution contractions
    gather_flops: float = 0.0   # patch extraction (data movement)
    mul_flops: float = 0.0      # elementwise multiplies
    other_flops: float = 0.0    # remaining elementwise/reduce work
    out_bytes: float = 0.0      # bytes written by non-metadata ops

    def macs(self) -> float:
        """MAC-bearing compute: contractions only (BN/activations excluded)."""
        return self.dot_macs + self.conv_macs

    def flops(self) -> float:
        return (2.0 * (self.dot_macs + self.conv_macs) + self.mul_flops
                + self.other_flops)

    def add(self, other: "OpCounts", scale: float = 1.0) -> None:
        self.dot_macs += scale * other.dot_macs
        self.conv_macs += scale * other.conv_macs
        self.gather_flops += scale * other.gather_flops
        self.mul_flops += scale * other.mul_flops
        self.other_flops += scale * other.other_flops
        self.out_bytes += scale * other.out_bytes

    def to_dict(self) -> Dict[str, float]:
        return {"dot_macs": self.dot_macs, "conv_macs": self.conv_macs,
                "gather_flops": self.gather_flops, "mul_flops": self.mul_flops,
                "other_flops": self.other_flops, "out_bytes": self.out_bytes}


@dataclass
class ProgramCosts:
    """Counter result: per-scope counts plus program-level flags."""

    by_scope: Dict[str, OpCounts] = field(default_factory=dict)
    unknown_trips: int = 0      # loops whose trip count is not known: none
                                # in a program that ran

    def scope(self, tag: str) -> OpCounts:
        if tag not in self.by_scope:
            self.by_scope[tag] = OpCounts()
        return self.by_scope[tag]

    def total(self) -> OpCounts:
        t = OpCounts()
        for c in self.by_scope.values():
            t.add(c)
        return t

    def to_dict(self) -> Dict[str, Any]:
        return {"by_scope": {k: v.to_dict()
                             for k, v in sorted(self.by_scope.items())},
                "total": self.total().to_dict(),
                "unknown_trips": self.unknown_trips}


def op_name(func) -> str:
    """The op's name without its overload and in-place suffix
    (``aten.add_.Tensor`` -> ``add``)."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _tensors(obj) -> List[torch.Tensor]:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _numel(t: torch.Tensor) -> float:
    return float(math.prod(t.shape))


def _nbytes(ts: List[torch.Tensor]) -> float:
    return sum(_numel(t) * t.element_size() for t in ts)


def contracted_size(name: str, args) -> float:
    """The contracted extent of a contraction's first (matrix) operand."""
    lhs = args[1] if name in ("addmm", "baddbmm", "addbmm", "addmv") \
        else args[0]
    return float(lhs.shape[-1])


def conv_macs_per_output(args) -> float:
    """cin-per-group x kernel spatial size of a ``convolution``'s weight
    (PyTorch's ``(cout, cin / groups, *kernel)`` layout)."""
    w = args[1]
    return float(math.prod(w.shape[1:]))


def count_op(c: OpCounts, func, args, out, gathering: bool) -> None:
    """Add one dispatched op's counts to ``c`` (the module doc's rules)."""
    if func.is_view:
        return
    name = op_name(func)
    outs = _tensors(out)
    if not outs:
        return
    out_bytes = _nbytes(outs)
    n_out = _numel(outs[0])
    if gathering:
        c.gather_flops += n_out
        c.out_bytes += out_bytes
        return
    tags = func.tags
    if name in _DOTS:
        c.dot_macs += n_out * contracted_size(name, args)
    elif name in _CONVS:
        c.conv_macs += n_out * conv_macs_per_output(args)
    elif name == "mul":
        c.mul_flops += n_out
    elif name == "addcmul":
        c.mul_flops += n_out
        c.other_flops += n_out
    elif name in _SOFTMAX:
        c.other_flops += SOFTMAX_FLOPS * n_out
    elif name in _FREE:
        return
    elif torch.Tag.reduction in tags:
        operands = _tensors(args)
        c.other_flops += _numel(operands[0]) if operands else n_out
    elif torch.Tag.pointwise in tags:
        c.other_flops += n_out
    c.out_bytes += out_bytes


class OpCounter(TorchDispatchMode):
    """Counts each dispatched op into ``costs`` under the innermost open
    ``cost_scope``."""

    def __init__(self, costs: ProgramCosts):
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count_op(self.costs.scope(cost.current_scope()), func, args, out,
                 cost.in_patch_extraction())
        return out


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import conv, flash_attn, graph_cond, \
        psg_matmul, quant
    return {f"{m.__name__}.{n}": c
            for m in (conv, psg_matmul, flash_attn, quant, graph_cond)
            for n, c in m.LAUNCHES.items()}


def op_costs(fn: Callable, *args, **kwargs) -> ProgramCosts:
    """Run ``fn(*args, **kwargs)`` under the counter and return its
    per-scope counts.  Raises if the program reaches the kernel dispatch
    layer or launches a CUDA kernel of the port (see the module doc)."""
    costs = ProgramCosts()
    before = _launch_counts()
    with cost.listening(counting=True), OpCounter(costs):
        fn(*args, **kwargs)
    after = _launch_counts()
    launched = {n: after[n] - before[n] for n in after
                if after[n] != before[n]}
    if launched:
        raise RuntimeError(f"the counted program launched kernels "
                           f"{launched}, which the op counter cannot see")
    return costs
