"""Selective Layer Update (SLU, paper §3.2): the weight-shared LSTM gate.

The gate pools a block's input over batch and space, zero-pads it to the
widest stage, projects it to ``gate_proj`` features and steps an LSTM of
``gate_hidden`` units; a linear head gives the keep probability of the
block, floored at ``min_keep_prob``.  One gate serves every block, and its
LSTM state runs through the blocks in order.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.core.config import SLUConfig

GateState = Tuple[torch.Tensor, torch.Tensor]


def dense_init(shape, generator: torch.Generator, scale: float = 1.0
               ) -> torch.Tensor:
    """Fan-in truncated-normal init at +-2 sigma (the JAX package's
    ``models/layers.dense_init``)."""
    std = scale / max(shape[0], 1) ** 0.5
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    return t


class Gate(nn.Module):
    def __init__(self, d_in: int, slu: SLUConfig, generator: torch.Generator):
        super().__init__()
        h, pj = slu.gate_hidden, slu.gate_proj
        self.slu = slu
        self.proj = nn.Parameter(dense_init((d_in, pj), generator))
        self.lstm_wx = nn.Parameter(dense_init((pj, 4 * h), generator))
        self.lstm_wh = nn.Parameter(dense_init((h, 4 * h), generator))
        self.lstm_b = nn.Parameter(torch.zeros(4 * h))
        self.head_w = nn.Parameter(dense_init((h, 1), generator))
        self.head_b = nn.Parameter(torch.zeros(1))

    def init_state(self) -> GateState:
        z = torch.zeros(self.slu.gate_hidden, device=self.proj.device)
        return z, z

    def forward(self, x: torch.Tensor, state: GateState
                ) -> Tuple[torch.Tensor, GateState]:
        """x: (B, H, W, C) block input -> (keep probability, new state)."""
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
