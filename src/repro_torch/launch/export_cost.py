"""Cost totals of the lowered program: the graph ``torch.export`` hands a
compiler.

The counterpart of the JAX package's ``launch/hlo_cost.py``, which
re-derives FLOPs and bytes from XLA's compiled HLO.  Here the program is
``torch.export.export(module, args, strict=False).run_decompositions()``:
the core-ATen graph of the program, which the port's own code does not
walk at run time (``analysis/op_cost.py`` counts the ops as they run; this
module reads the graph, node by node, from each node's ``val``
metadata).  The rules are ``hlo_cost``'s:

* a contraction (``mm``, ``bmm``, ``addmm``, ``baddbmm``) counts 2 FLOPs a
  MAC; a ``convolution`` (which ``hlo_cost`` leaves uncounted, the
  reference lowering its convs to patches and dots) likewise, as the
  contraction it is;
* an elementwise op counts 1 FLOP an output element, comparisons and
  selects included (``hlo_cost``'s ``compare``/``select``); ``relu`` is
  one ``maximum``, ``hardtanh`` two (``relu6``'s ``maximum`` and
  ``minimum``); ``_softmax`` three an element and ``_log_softmax`` three
  (the subtraction, ``exp``, the division or ``log``: XLA's reductions
  count no FLOPs); ``mean`` one an output element (its division);
* every counted op is charged the bytes it reads plus writes; views are
  free; there is no fusion, so the bytes are an upper bound that nothing
  reconciles;
* control flow: a ``cond`` counts its largest branch; a ``while_loop``
  counts its body once and is flagged in ``unknown_trip_count`` (never a
  guessed trip count: the audit fails on it).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
                   "dot"})
_CONVS = frozenset({"convolution", "_convolution"})
# HLO's elementwise ops (hlo_cost._ELEMWISE) as core ATen names
_ELEMWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "exp", "tanh", "rsqrt", "sqrt",
    "pow", "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "eq",
    "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "bitwise_and", "bitwise_or", "neg", "abs", "floor", "sign", "sigmoid",
    "log", "cos", "sin", "relu", "reciprocal", "masked_fill", "erf",
    "expm1", "log1p", "ceil", "round", "remainder", "fmod", "atan2",
})
_FLOPS_PER_ELEMENT = {"hardtanh": 2, "_softmax": 3, "_log_softmax": 3,
                      "silu": 2, "gelu": 8}
_HOP_COND = "cond"
_HOP_WHILE = "while_loop"


def _name(target) -> str:
    if hasattr(target, "overloadpacket"):
        return target.overloadpacket.__name__
    return getattr(target, "__name__", str(target))


def _vals(obj) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    if isinstance(obj, torch.fx.Node):
        v = obj.meta.get("val")
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            out.extend(_vals(o))
    return out


def _numel(t: torch.Tensor) -> float:
    return float(math.prod(t.shape))


def _bytes(ts: List[torch.Tensor]) -> float:
    return sum(_numel(t) * t.element_size() for t in ts)


def sub_graphs(gm: torch.fx.GraphModule, node: torch.fx.Node
               ) -> Tuple[List[torch.fx.GraphModule], bool]:
    """The sub-programs of a control-flow node and whether they are a
    branch set (``cond``) rather than a loop body (``while_loop``); the
    counterpart of ``jaxpr_cost.sub_jaxprs``."""
    name = _name(node.target)
    if name == _HOP_COND:
        return [getattr(gm, a.target) for a in node.args[1:3]], True
    if name == _HOP_WHILE:
        return [getattr(gm, node.args[1].target)], False
    return [], False


class ExportCost:
    def __init__(self):
        self.unknown_trip_loops = 0

    def node_cost(self, gm: torch.fx.GraphModule, node: torch.fx.Node
                  ) -> Tuple[float, float]:
        """(FLOPs, bytes) of one ``call_function`` node."""
        target = node.target
        if getattr(target, "is_view", False):
            return 0.0, 0.0
        subs, branches = sub_graphs(gm, node)
        if subs:
            costs = [self.graph_cost(s) for s in subs]
            if branches:
                return max(c[0] for c in costs), max(c[1] for c in costs)
            self.unknown_trip_loops += 1
            return costs[0]
        name = _name(target)
        outs = _vals(node)
        if not outs:
            return 0.0, 0.0
        ins = _vals(list(node.args)) + _vals(list(node.kwargs.values()))
        io = _bytes(outs) + _bytes(ins)
        n_out = _numel(outs[0])
        if name in _DOTS:
            lhs = ins[1] if name in ("addmm", "baddbmm", "addbmm", "addmv") \
                else ins[0]
            return 2.0 * n_out * lhs.shape[-1], io
        if name in _CONVS:
            return 2.0 * n_out * math.prod(ins[1].shape[1:]), io
        if name in _ELEMWISE:
            return n_out, io
        if name in _FLOPS_PER_ELEMENT:
            return _FLOPS_PER_ELEMENT[name] * n_out, io
        if name == "mean":
            return n_out, io
        return 0.0, io

    def graph_cost(self, gm: torch.fx.GraphModule) -> Tuple[float, float]:
        fl = io = 0.0
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            f, b = self.node_cost(gm, node)
            fl += f
            io += b
        return fl, io


def analyze_graph(gm: torch.fx.GraphModule) -> Dict[str, float]:
    """``{"flops", "bytes", "unknown_trip_count"}`` of a lowered graph
    (``hlo_cost.analyze``'s keys)."""
    ec = ExportCost()
    fl, io = ec.graph_cost(gm)
    return {"flops": fl, "bytes": io,
            "unknown_trip_count": float(ec.unknown_trip_loops)}


class _Program(torch.nn.Module):
    """``fn(*modules, *inputs)`` as a module for ``torch.export`` (which
    takes modules): the modules are registered so their parameters and
    buffers become the program's."""

    def __init__(self, fn: Callable, modules: Tuple[torch.nn.Module, ...]):
        super().__init__()
        self.fn = fn
        self.mods = torch.nn.ModuleList(modules)

    def forward(self, *inputs):
        return self.fn(*self.mods, *inputs)


def lower(fn: Callable, modules: Tuple[torch.nn.Module, ...],
          inputs: Tuple) -> torch.fx.GraphModule:
    """The core-ATen graph of ``fn(*modules, *inputs)``."""
    ep = torch.export.export(_Program(fn, modules), tuple(inputs),
                             strict=False)
    return ep.run_decompositions().graph_module


def analyze(fn: Callable, modules: Tuple[torch.nn.Module, ...],
            inputs: Tuple) -> Dict[str, float]:
    """Lower ``fn(*modules, *inputs)`` and count it (:func:`analyze_graph`)."""
    return analyze_graph(lower(fn, modules, inputs))
