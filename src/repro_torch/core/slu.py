"""Selective Layer Update (SLU, paper §3.2): the weight-shared LSTM gate,
the gated residual and the FLOPs regularizer.

The gate pools a block's input over every axis but the channels (batch and
space, or batch and sequence), zero-pads it to the gate's width, projects
it to ``gate_proj`` features and steps an LSTM of ``gate_hidden`` units; a
linear head gives the keep probability of the block, floored at
``min_keep_prob``.  One gate serves every block, and its LSTM state runs
through the blocks in order.

The keep decision is ``jax.random.bernoulli(key, p)``, which is ``uniform(key)
< float32(p)``, and the uniform does not depend on ``p``: the host draws
each gated block's uniform with the JAX package's key ahead of the step
(:func:`resnet_uniforms`, :func:`lm_uniforms`), and :func:`gated_residual`
compares it with the gate's probability.  Outside a captured CUDA graph the
comparison is on the host (it reads ``p`` back from the device); inside
one it is on the card (``kernels/graph_cond.slu_decide``) and the block is
an IF node of the graph, so a chunk of captured steps reads nothing back.
Either way the decisions are the JAX package's, bit for bit.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core import rng
from repro_torch.core.config import SLUConfig
from repro_torch.models.layers import dense_init

Uniform = Union[float, np.floating, torch.Tensor]

GateState = Tuple[torch.Tensor, torch.Tensor]


class Gate(nn.Module):
    def __init__(self, d_in: int, slu: SLUConfig, generator: torch.Generator):
        super().__init__()
        h, pj = slu.gate_hidden, slu.gate_proj
        self.slu = slu
        self.proj = nn.Parameter(dense_init((d_in, pj), generator))
        self.lstm_wx = nn.Parameter(dense_init((pj, 4 * h), generator))
        self.lstm_wh = nn.Parameter(dense_init((h, 4 * h), generator))
        dev = generator.device
        self.lstm_b = nn.Parameter(torch.zeros(4 * h, device=dev))
        self.head_w = nn.Parameter(dense_init((h, 1), generator))
        self.head_b = nn.Parameter(torch.zeros(1, device=dev))

    def init_state(self) -> GateState:
        z = torch.zeros(self.slu.gate_hidden, device=self.proj.device)
        return z, z

    def forward(self, x: torch.Tensor, state: GateState
                ) -> Tuple[torch.Tensor, GateState]:
        """x: block input, channels last -> (keep probability, new
        state)."""
        pooled = x.float().mean(dim=tuple(range(x.dim() - 1)))
        d_in = self.proj.shape[0]
        if pooled.shape[0] < d_in:
            pooled = nn.functional.pad(pooled, (0, d_in - pooled.shape[0]))
        z = pooled @ self.proj
        h_prev, c_prev = state
        g = z @ self.lstm_wx + h_prev @ self.lstm_wh + self.lstm_b
        i_t, f_t, o_t, u_t = torch.chunk(g, 4)
        c = torch.sigmoid(f_t + 1.0) * c_prev \
            + torch.sigmoid(i_t) * torch.tanh(u_t)
        h = torch.sigmoid(o_t) * torch.tanh(c)
        logit = (h @ self.head_w + self.head_b)[0]
        p = torch.clamp(torch.sigmoid(logit), self.slu.min_keep_prob, 1.0)
        return p, (h, c)


def resnet_uniforms(key: rng.Key, n_blocks: int) -> np.ndarray:
    """The uniforms of a ResNet step's keep draws, fp32 ``(n_blocks,)``:
    block ``glob`` draws ``uniform(fold_in(key, glob))`` (the JAX package's
    ``bernoulli(fold_in(rng, glob), p)``)."""
    return np.array([rng.uniform(rng.fold_in(key, g)) for g in range(n_blocks)],
                    np.float32)


def lm_uniforms(key: rng.Key, num_layers: int) -> np.ndarray:
    """The uniforms of an LM step's keep draws, fp32 ``(2 L,)`` in
    sub-block order: layer ``i`` splits ``fold_in(fold_in(key, i), 0)`` into
    the mixer's and the ffn's key (the JAX package's unit keys)."""
    out = []
    for i in range(num_layers):
        for r in rng.split(rng.fold_in(rng.fold_in(key, i), 0)):
            out.append(rng.uniform(r))
    return np.array(out, np.float32)


def gated_residual(block_fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor, keep_prob: torch.Tensor,
                   u: Optional[Uniform], force_keep: bool,
                   modules: Sequence[nn.Module] = (),
                   keep: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x + g * block(x)`` where the block is kept, else ``x``; returns
    ``(output, executed)``, ``executed`` a 0-d fp32 tensor (1. or 0.) on
    ``x``'s device.

    ``keep = force_keep | (u < keep_prob)`` in fp32, ``u`` the block's
    uniform (:func:`resnet_uniforms`, :func:`lm_uniforms`; unused when
    forced); ``keep`` (tests) injects the decision.  An executed branch is
    scaled by the straight-through factor ``g = 1 + p - p.detach()`` (cast
    to ``x.dtype``), so the task loss reaches the gate.  ``modules`` hold
    the parameters ``block_fn`` reads; the block runs on fresh leaves that
    alias them (and the active PSG probe), so that its inner autograd graph
    lives on the stream it runs on.

    While a CUDA graph is captured with a ``kernels/graph_cond.CondGraph``
    active (``graph_cond.capturing``), an unforced decision is taken on
    the card from ``u``, a CUDA tensor, and the block's forward and its
    backward are IF nodes of the graph.  A skipped block gives the JAX
    package's ``lax.cond`` result: output ``x`` (copied before the node, so
    a ``-0.0`` stays one), zero gradients for its parameters and for the
    probe, and its BatchNorm statistics untouched.  A block skipped on the
    host returns ``x`` itself, off the autograd graph of its parameters
    (their gradients are ``None``, which the train step takes as zeros).
    """
    from repro_torch.core import psg
    from repro_torch.kernels import graph_cond

    cg = None
    if keep is None:
        if force_keep:
            keep = True
        elif x.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            cg = graph_cond.active()
            if cg is None:
                raise RuntimeError("a gated block inside a CUDA graph "
                                   "capture needs graph_cond.capturing(...)")
            if not isinstance(u, torch.Tensor) or u.device != x.device:
                raise RuntimeError("a captured SLU decision needs its "
                                   "uniform as a tensor on the card")
        elif isinstance(u, torch.Tensor):
            keep = bool(u.float() < keep_prob.detach().float())
        else:
            keep = bool(np.float32(u) < np.float32(float(keep_prob.detach())))
    if keep is False:          # decided on the host: no node, no grad path
        return x, torch.zeros((), device=x.device)
    cfg, probe = psg.snapshot()
    if psg.active_config() is None:
        probe = None
    named = [dict(m.named_parameters()) for m in modules]
    params = [q for d in named for q in d.values()]
    decide = (block_fn, keep, u, cg, cfg, probe is not None, modules, named)
    return _GatedResidual.apply(
        decide, x, keep_prob, probe if probe is not None else x.new_empty(0),
        *params)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


class _GatedResidual(torch.autograd.Function):
    """The gated residual as one autograd node.  The forward runs the
    branch under ``enable_grad`` on leaves that alias its input, the gate's
    probability, the probe and the block's parameters, in the forward's IF
    node when the decision is on the card, and keeps that inner graph; the
    backward differentiates it (``torch.autograd.grad``), in a second IF
    node on the saved flag.  Fills before each node give the skipped
    block's result."""

    @staticmethod
    def forward(ctx, decide, x, p, probe, *params):
        from torch.nn.utils.stateless import _reparametrize_module

        from repro_torch.core import psg
        block_fn, keep, u, cg, cfg, has_probe, modules, named = decide
        ctx.keep, ctx.cg, ctx.has_probe = keep, cg, has_probe
        ctx.inner = None
        out = x.clone()

        def body():
            with torch.enable_grad(), contextlib.ExitStack() as stack:
                leaves = [_leaf(x), _leaf(p)] + \
                    ([_leaf(probe)] if has_probe else [])
                for m, d in zip(modules, named):
                    alias = {n: _leaf(q) for n, q in d.items()}
                    stack.enter_context(_reparametrize_module(m, alias))
                    leaves += list(alias.values())
                if has_probe:
                    stack.enter_context(psg.enable(cfg, leaves[2]))
                pd = leaves[1]
                g_st = (1.0 + pd - pd.detach()).to(x.dtype)
                t = g_st * block_fn(leaves[0])
            out.add_(t.detach())
            ctx.inner = (t, leaves)

        if cg is None:
            flag = torch.ones((), device=x.device)
            body()
        else:
            from repro_torch.kernels import graph_cond
            h = cg.handle()
            flag = graph_cond.slu_decide(u.reshape(()).float(),
                                         p.detach().float(), handle=h)
            with cg.if_node(h):
                body()
        ctx.flag = flag
        ctx.save_for_backward(probe, *params)
        ctx.mark_non_differentiable(flag)
        return out, flag

    @staticmethod
    def backward(ctx, gout, _gflag):
        probe, *params = ctx.saved_tensors
        dx = gout.clone()
        dp = torch.zeros((), dtype=torch.float32, device=gout.device)
        dprobe = torch.zeros_like(probe) if ctx.has_probe else None
        dparams = [torch.zeros_like(q) for q in params]
        outs = [dp] + ([dprobe] if ctx.has_probe else []) + dparams

        def body():
            t, leaves = ctx.inner
            gs = torch.autograd.grad(t, leaves, gout, allow_unused=True)
            if gs[0] is not None:
                dx.add_(gs[0])
            for dst, g in zip(outs, gs[1:]):
                if g is not None:
                    dst.copy_(g)

        cg = ctx.cg
        if cg is None:
            body()
        else:
            from repro_torch.kernels import graph_cond
            h = cg.handle()
            # the saved flag sets the node: keep iff 0 < flag
            graph_cond.slu_decide(torch.zeros_like(ctx.flag), ctx.flag,
                                  handle=h)
            with cg.if_node(h):
                body()
        ctx.inner = None
        return (None, dx, dp, dprobe, *dparams)


def flops_regularizer(keep_probs: torch.Tensor,
                      block_flops: torch.Tensor) -> torch.Tensor:
    """C(W, G) of Eq. 1: expected executed FLOPs, normalized to [0, 1]."""
    return torch.sum(keep_probs * block_flops) / torch.clamp_min(
        torch.sum(block_flops), 1.0)
