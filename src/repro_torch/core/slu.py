"""Selective Layer Update (SLU, paper §3.2): the weight-shared LSTM gate,
the gated residual and the FLOPs regularizer.

The gate pools a block's input over every axis but the channels (batch and
space, or batch and sequence), zero-pads it to the gate's width, projects
it to ``gate_proj`` features and steps an LSTM of ``gate_hidden`` units; a
linear head gives the keep probability of the block, floored at
``min_keep_prob``.  One gate serves every block, and its LSTM state runs
through the blocks in order.

:func:`gated_residual` draws the keep decision on the host with the JAX
package's key (``core/rng.py``), so the decisions are the JAX package's;
each draw reads the keep probability back from the device.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from repro_torch.core import rng
from repro_torch.core.config import SLUConfig
from repro_torch.models.layers import dense_init

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


def gated_residual(block_fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor, keep_prob: torch.Tensor, key: rng.Key,
                   force_keep: bool) -> Tuple[torch.Tensor, float]:
    """``x + block(x)`` with probability ``keep_prob``, else ``x``; returns
    ``(output, executed in {0., 1.})``.

    ``keep = bernoulli(key, keep_prob) | force_keep``; a forced block skips
    the draw and the host read.  An executed branch is scaled by the
    straight-through factor ``1 + p - p.detach()`` (cast to ``x.dtype``),
    so the task loss reaches the gate.
    """
    keep = force_keep or bool(rng.bernoulli(key, float(keep_prob.detach())))
    if not keep:
        return x, 0.0
    g_st = (1.0 + keep_prob - keep_prob.detach()).to(x.dtype)
    return x + g_st * block_fn(x), 1.0


def flops_regularizer(keep_probs: torch.Tensor,
                      block_flops: torch.Tensor) -> torch.Tensor:
    """C(W, G) of Eq. 1: expected executed FLOPs, normalized to [0, 1]."""
    return torch.sum(keep_probs * block_flops) / torch.clamp_min(
        torch.sum(block_flops), 1.0)
