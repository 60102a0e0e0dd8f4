"""CIFAR ResNet (6n+2) with SLU-gated residual blocks and PSG convs.

The counterpart of the ResNet half of the JAX package's
``models/resnet.py``.  Parameters are ``nn.Parameter``s; the BatchNorm
running statistics are buffers, updated in place by a train-mode forward
and never seen by the optimizer.  Each stage holds one transition block
(with a 1x1 stride-2 ``down`` shortcut where the width changes; such a
block is never gated) and ``n - 1`` identity blocks, run by a Python loop.

A gated block draws ``keep ~ Bernoulli(p)`` from the gate's probability
with the JAX package's key, ``fold_in(step_rng, block)`` (``core/rng.py``),
forced on for the first and last block, so the decisions are the JAX
package's.  The decision is taken on the host, so each gated block costs
one device-to-host read of ``p``.  A skipped block passes its
input and its BatchNorm state through unchanged and launches no kernel.

Every conv is ``psg.conv2d``: the implicit-GEMM kernels when the active
PSG config's ``fused_conv`` resolves on (``psg.fused_conv_active``),
otherwise the JAX package's materialized im2col through ``psg.matmul``
(the PSG matmul kernels under PSG, a plain product without it).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import psg, rng
from repro_torch.core.config import E2TrainConfig
from repro_torch.core.slu import Gate, GateState
from repro_torch.models.layers import dense_init

BN_MOMENTUM = 0.9           # running-stat EMA decay per executed train step
BN_EPS = 1e-5


def resnet_depth_to_n(depth: int) -> int:
    if (depth - 2) % 6:
        raise ValueError(f"CIFAR ResNet depth must be 6n+2, got {depth}")
    return (depth - 2) // 6


class Conv(nn.Module):
    """Patch-major ``(k*k*cin, cout)`` weight; SAME padding."""

    def __init__(self, cin: int, cout: int, k: int, generator: torch.Generator):
        super().__init__()
        self.k = k
        self.w = nn.Parameter(dense_init((k * k * cin, cout), generator,
                                         scale=1.41))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return psg.conv2d(x, self.w, k=self.k, stride=stride)


class BatchNorm(nn.Module):
    """Affine parameters plus running-stat buffers over NHWC channels."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode: normalize with the batch statistics and move the
        running statistics toward them."""
        mu = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), correction=0)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1.0 - BN_MOMENTUM) * mu)
            self.var.copy_(BN_MOMENTUM * self.var + (1.0 - BN_MOMENTUM) * var)
        return (x - mu) * torch.rsqrt(var + BN_EPS) * self.scale + self.bias


class Block(nn.Module):
    def __init__(self, cin: int, cout: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, generator)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv(cout, cout, 3, generator)
        self.bn2 = BatchNorm(cout)
        self.down = Conv(cin, cout, 1, generator) if cin != cout else None

    def branch(self, h: torch.Tensor, stride: int) -> torch.Tensor:
        """conv-BN-relu-conv-BN residual branch."""
        y = F.relu(self.bn1(self.conv1(h, stride)))
        return self.bn2(self.conv2(y))


class ResNet(nn.Module):
    def __init__(self, depth: int, num_classes: int = 10,
                 e2: Optional[E2TrainConfig] = None, width: int = 16,
                 seed: int = 0):
        super().__init__()
        self.n = resnet_depth_to_n(depth)
        self.e2 = e2 or E2TrainConfig()
        g = torch.Generator().manual_seed(seed)
        self.stem = Conv(3, width, 3, g)
        self.stem_bn = BatchNorm(width)
        self.stages = nn.ModuleList()
        cin = width
        for cout in (width, 2 * width, 4 * width):
            self.stages.append(nn.ModuleList(
                [Block(cin, cout, g)]
                + [Block(cout, cout, g) for _ in range(self.n - 1)]))
            cin = cout
        self.fc_w = nn.Parameter(dense_init((4 * width, num_classes), g))
        self.fc_b = nn.Parameter(torch.zeros(num_classes))
        # weight-shared gate on channel-pooled features, padded to max width
        self.slu_gate = Gate(4 * width, self.e2.slu, g) \
            if self.e2.slu.enabled else None

    def forward(self, x: torch.Tensor, key: Optional[rng.Key] = None,
                keep: Optional[Sequence[bool]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Train-mode forward, x: (B, 32, 32, 3) -> (logits, aux{slu_*}).

        ``key`` is the step's threefry key (``fold_in(PRNGKey(seed),
        step)``, default ``PRNGKey(0)``) and keys the SLU draws; ``keep``
        (tests only) overrides them with one decision per block, in network
        order.
        """
        slu_cfg = self.e2.slu
        key = rng.PRNGKey(0) if key is None else key
        slu_on = self.slu_gate is not None
        n_blocks = 3 * self.n
        one = torch.ones((), device=x.device)
        h = F.relu(self.stem_bn(self.stem(x)))
        gst: Optional[GateState] = self.slu_gate.init_state() if slu_on else None
        kps, exs = [], []
        for stage, blocks in enumerate(self.stages):
            for b, blk in enumerate(blocks):
                glob = stage * self.n + b
                if blk.down is not None:
                    stride = 2 if stage > 0 else 1
                    h = F.relu(blk.down(h, stride) + blk.branch(h, stride))
                    kps.append(one)
                    exs.append(1.0)
                    continue
                if not slu_on:
                    h = F.relu(h + blk.branch(h, 1))
                    kps.append(one)
                    exs.append(1.0)
                    continue
                pkeep, gst = self.slu_gate(h, gst)
                if keep is not None:
                    run = bool(keep[glob])
                else:
                    force = slu_cfg.never_skip_first_last and \
                        glob in (0, n_blocks - 1)
                    run = force or bool(rng.bernoulli(
                        rng.fold_in(key, glob), float(pkeep.detach())))
                if run:
                    g_st = 1.0 + pkeep - pkeep.detach()   # straight-through
                    h = h + g_st * blk.branch(h, 1)
                h = F.relu(h)
                kps.append(pkeep)
                exs.append(float(run))
        pooled = h.mean(dim=(1, 2))
        logits = pooled @ self.fc_w + self.fc_b
        kps_t = torch.stack(kps)
        aux = {"slu_cost": kps_t.mean() if slu_on else one,
               "slu_executed": torch.tensor(exs, device=x.device),
               "slu_keep_probs": kps_t}
        return logits, aux


def resnet_loss(model: ResNet, batch: Dict[str, torch.Tensor],
                key: Optional[rng.Key] = None,
                keep: Optional[Sequence[bool]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy + SLU FLOPs regularizer (Eq. 1); returns ``(total,
    metrics)``.  The BatchNorm state is updated in place on ``model``."""
    e2 = model.e2
    logits, aux = model(batch["image"], key=key, keep=keep)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, batch["label"].long()[:, None]).mean()
    total = nll + e2.slu.alpha * aux["slu_cost"] if e2.slu.enabled else nll
    metrics = {"loss": nll, "slu_cost": aux["slu_cost"],
               "slu_exec_ratio": aux["slu_executed"].mean()}
    return total, metrics
