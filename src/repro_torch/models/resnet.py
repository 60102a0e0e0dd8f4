"""CIFAR ResNet (6n+2) with SLU-gated residual blocks and PSG convs, and
the CIFAR MobileNetV2.

The counterpart of the JAX package's ``models/resnet.py``.  Parameters are ``nn.Parameter``s; the BatchNorm
running statistics are buffers, updated in place by a train-mode forward
and never seen by the optimizer; an eval-mode forward (``model.eval()``)
normalizes with them and runs every block, the SLU gate unevaluated.  Each stage holds one transition block
(with a 1x1 stride-2 ``down`` shortcut where the width changes; such a
block is never gated) and ``n - 1`` identity blocks, run by a Python loop.

A gated block draws ``keep ~ Bernoulli(p)`` from the gate's probability
with the JAX package's key, ``fold_in(step_rng, block)`` (``core/rng.py``),
forced on for the first and last block, so the decisions are the JAX
package's: ``core/slu.gated_residual`` compares the block's uniform, drawn
on the host ahead of the step, with ``p``.  Eagerly the comparison is on
the host (one read of ``p`` per gated block); inside a captured CUDA graph
it is on the card and the block is an IF node (``kernels/graph_cond.py``).
A skipped block passes its input and its BatchNorm state through unchanged
and launches no kernel of its branch.

Every conv is ``psg.conv2d``: the implicit-GEMM kernels when the active
PSG config's ``fused_conv`` resolves on (``psg.fused_conv_active``),
otherwise the JAX package's materialized im2col through ``psg.matmul``
(the PSG matmul kernels under PSG, a plain product without it).

:class:`MobileNetV2` (stem 3->32, seventeen inverted residuals per
``core/cost.MBV2_CFG``, a 1x1 head to 1280, then fc) reuses ``Conv`` and
``BatchNorm``, with relu6.  It has no SLU gate: its loss is the NLL alone
and reports full execution, as the JAX package's does.  Its 3x3 depthwise
conv (:func:`depthwise`) is plain PyTorch, as the JAX package computes it
outside any kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import psg, rng
from repro_torch.core.config import E2TrainConfig
from repro_torch.core.cost import MBV2_HEAD, MBV2_STEM, cost_scope, \
    mbv2_layout
from repro_torch.core.slu import Gate, GateState, gated_residual, \
    resnet_uniforms
from repro_torch.distributed import sharding
from repro_torch.models.layers import dense_init, init_generator

Uniforms = Union[np.ndarray, torch.Tensor]

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
        running statistics toward them.  Eval mode: normalize with the
        running statistics and leave them.  Under a mesh the batch
        statistics are the global batch's (``distributed/sharding``), so
        the running statistics are equal on every rank."""
        if not self.training:
            return (x - self.mean) * torch.rsqrt(self.var + BN_EPS) \
                * self.scale + self.bias
        mu = sharding.global_mean(x, (0, 1, 2))
        if sharding.data_group() is None:
            var = x.var(dim=(0, 1, 2), correction=0)
        else:
            var = sharding.global_mean((x - mu) ** 2, (0, 1, 2))
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
        """Drawn on the CPU; inside ``torch.device("meta")`` nothing is
        drawn (``tasks/cifar_cnn``)."""
        super().__init__()
        self.n = resnet_depth_to_n(depth)
        self.e2 = e2 or E2TrainConfig()
        g = init_generator(seed)
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
                keep: Optional[Sequence[bool]] = None,
                slu_u: Optional[Uniforms] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: (B, 32, 32, 3) -> (logits, aux{slu_*}).

        ``key`` is the step's threefry key (``fold_in(PRNGKey(seed),
        step)``, default ``PRNGKey(0)``) and keys the SLU draws; ``slu_u``
        gives their uniforms instead (``core/slu.resnet_uniforms`` of that
        key, one per block in network order; a CUDA tensor inside a captured
        step); ``keep`` (tests only) overrides the decisions with one per
        block, in network order.  In eval mode (``self.training`` false)
        the BatchNorms use their running statistics and every block runs
        ungated, as in the JAX package's ``train=False``.
        """
        slu_cfg = self.e2.slu
        slu_on = self.slu_gate is not None and self.training
        n_blocks = 3 * self.n
        if slu_on and slu_u is None and keep is None:
            slu_u = resnet_uniforms(rng.PRNGKey(0) if key is None else key,
                                    n_blocks)
        one = torch.ones((), device=x.device)
        with cost_scope("stem"):
            h = F.relu(self.stem_bn(self.stem(x)))
        gst: Optional[GateState] = self.slu_gate.init_state() if slu_on else None
        kps, exs = [], []
        for stage, blocks in enumerate(self.stages):
            for b, blk in enumerate(blocks):
                glob = stage * self.n + b
                # the audit's groups: block 0 of a stage, then the others
                scope = f"s{stage}.trans" if b == 0 else f"s{stage}.rest"
                with cost_scope(scope):
                    if blk.down is not None:
                        stride = 2 if stage > 0 else 1
                        h = F.relu(blk.down(h, stride) + blk.branch(h, stride))
                        kps.append(one)
                        exs.append(one)
                        continue
                    if not slu_on:
                        h = F.relu(h + blk.branch(h, 1))
                        kps.append(one)
                        exs.append(one)
                        continue
                    pkeep, gst = self.slu_gate(h, gst)
                    force = slu_cfg.never_skip_first_last and \
                        glob in (0, n_blocks - 1)
                    h, ex = gated_residual(
                        lambda t, blk=blk: blk.branch(t, 1), h, pkeep,
                        None if slu_u is None else slu_u[glob], force,
                        modules=(blk,),
                        keep=None if keep is None else bool(keep[glob]))
                    h = F.relu(h)
                kps.append(pkeep)
                exs.append(ex)
        with cost_scope("fc"):
            pooled = h.mean(dim=(1, 2))
            logits = pooled @ self.fc_w + self.fc_b
        kps_t = torch.stack(kps)
        aux = {"slu_cost": kps_t.mean() if slu_on else one,
               "slu_executed": torch.stack(exs),
               "slu_keep_probs": kps_t}
        return logits, aux


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return sharding.global_mean(-logp.gather(1, labels.long()[:, None]))


def resnet_loss(model: ResNet, batch: Dict[str, torch.Tensor],
                key: Optional[rng.Key] = None,
                keep: Optional[Sequence[bool]] = None,
                slu_u: Optional[Uniforms] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy + SLU FLOPs regularizer (Eq. 1); returns ``(total,
    metrics)``.  The BatchNorm state is updated in place on ``model``."""
    e2 = model.e2
    logits, aux = model(batch["image"], key=key, keep=keep, slu_u=slu_u)
    nll = _nll(logits, batch["label"])
    total = nll + e2.slu.alpha * aux["slu_cost"] if e2.slu.enabled else nll
    metrics = {"loss": nll, "slu_cost": aux["slu_cost"],
               "slu_exec_ratio": aux["slu_executed"].mean()}
    return total, metrics


# ---------------------------------------------------------------------------
# MobileNetV2 (CIFAR variant)
# ---------------------------------------------------------------------------


def _dw_window(xp: torch.Tensor, t: int, stride: int, ho: int,
               wo: int) -> torch.Tensor:
    i, j = divmod(t, 3)
    return xp[:, i:i + (ho - 1) * stride + 1:stride,
              j:j + (wo - 1) * stride + 1:stride, :]


class Depthwise(torch.autograd.Function):
    """3x3 depthwise conv of NHWC ``x`` with a ``(9, C)`` weight, SAME
    padding, the JAX package's ``_depthwise``: the stride is applied to the
    window before the multiply.  The nine strided windows of the padded
    input are accumulated in tap order ``(i, j)`` into one fp32 tensor;
    no ``(B, H', W', 9, C)`` stack is formed, and only the padded input is
    saved.  The backward adds ``gy * w_t`` into each window of a zero
    padded gradient in tap order (in place, no atomics) and reduces
    ``window_t * gy`` over the positions for ``dw_t``: deterministic, and
    free of host syncs, so a CUDA graph can hold it."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        B, H, W, C = x.shape
        ho, wo = -(-H // stride), -(-W // stride)
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        y = _dw_window(xp, 0, stride, ho, wo) * w[0]
        for t in range(1, 9):
            y.addcmul_(_dw_window(xp, t, stride, ho, wo), w[t])
        ctx.save_for_backward(xp, w)
        ctx.stride, ctx.hw = stride, (H, W)
        return y

    @staticmethod
    def backward(ctx, gy):
        xp, w = ctx.saved_tensors
        stride, (H, W) = ctx.stride, ctx.hw
        ho, wo = gy.shape[1], gy.shape[2]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp = torch.zeros_like(xp)
            for t in range(9):
                _dw_window(dxp, t, stride, ho, wo).addcmul_(gy, w[t])
            dx = dxp[:, 1:H + 1, 1:W + 1, :]
        if ctx.needs_input_grad[1]:
            dw = torch.stack([
                (_dw_window(xp, t, stride, ho, wo) * gy).sum(dim=(0, 1, 2))
                for t in range(9)])
        return dx, dw, None


def depthwise(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """:class:`Depthwise`: ``(B, H, W, C) x (9, C) -> (B, ceil(H / s),
    ceil(W / s), C)``."""
    return Depthwise.apply(x, w, stride)


class InvertedResidual(nn.Module):
    """1x1 expand - BN - relu6 - 3x3 depthwise - BN - relu6 - 1x1 project -
    BN, with the identity added where ``residual``."""

    def __init__(self, cin: int, hidden: int, cout: int,
                 generator: torch.Generator, name: str = ""):
        super().__init__()
        self.name = name                 # the audit's group, b{i}
        self.expand = Conv(cin, hidden, 1, generator)
        self.bn1 = BatchNorm(hidden)
        self.dw = nn.Parameter(dense_init((9, hidden), generator))
        self.bn2 = BatchNorm(hidden)
        self.project = Conv(hidden, cout, 1, generator)
        self.bn3 = BatchNorm(cout)

    def forward(self, h: torch.Tensor, stride: int,
                residual: bool) -> torch.Tensor:
        y = F.relu6(self.bn1(self.expand(h)))
        with cost_scope(f"{self.name}.dw"):
            y = depthwise(y, self.dw, stride)
        y = F.relu6(self.bn2(y))
        y = self.bn3(self.project(y))
        return h + y if residual else y


class MobileNetV2(nn.Module):
    """The CIFAR MobileNetV2 at its published widths.  Parameter names are
    the JAX package's tree (``stem.w``, ``blocks.{i}.expand.w``,
    ``blocks.{i}.dw``, ``head.w``, ``fc_w``, ...); the static block layout
    (``core/cost.mbv2_layout``) stays off the parameters."""

    def __init__(self, num_classes: int = 10, seed: int = 0):
        super().__init__()
        self.layout = mbv2_layout()
        g = init_generator(seed)
        self.stem = Conv(3, MBV2_STEM, 3, g)
        self.stem_bn = BatchNorm(MBV2_STEM)
        self.blocks = nn.ModuleList(
            [InvertedResidual(cin, hidden, cout, g, name=f"b{i}")
             for i, (cin, hidden, cout, _, _) in enumerate(self.layout)])
        self.head = Conv(self.layout[-1][2], MBV2_HEAD, 1, g)
        self.head_bn = BatchNorm(MBV2_HEAD)
        self.fc_w = nn.Parameter(dense_init((MBV2_HEAD, num_classes), g))
        self.fc_b = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x: torch.Tensor, key: Optional[rng.Key] = None,
                keep: Optional[Sequence[bool]] = None,
                slu_u: Optional[Uniforms] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: (B, 32, 32, 3) -> (logits, aux).  ``key`` and ``slu_u`` are
        taken for the task's loss contract and unused (no gate draws);
        ``keep`` is refused.  ``aux`` reports full execution: ``slu_cost``
        1 and no SLU flags."""
        if keep is not None:
            raise ValueError("MobileNetV2 has no SLU gate; it takes no "
                             "injected keep mask")
        with cost_scope("stem"):
            h = F.relu6(self.stem_bn(self.stem(x)))
        for blk, (_, _, _, stride, residual) in zip(self.blocks, self.layout):
            with cost_scope(blk.name):
                h = blk(h, stride, residual)
        with cost_scope("head"):
            h = F.relu6(self.head_bn(self.head(h)))
        with cost_scope("fc"):
            logits = h.mean(dim=(1, 2)) @ self.fc_w + self.fc_b
        aux = {"slu_cost": x.new_ones(()), "slu_executed": x.new_ones((0,))}
        return logits, aux


def mobilenetv2_loss(model: MobileNetV2, batch: Dict[str, torch.Tensor],
                     key: Optional[rng.Key] = None,
                     keep: Optional[Sequence[bool]] = None,
                     slu_u: Optional[Uniforms] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy alone (no SLU term); the SLU metrics report full
    execution, as the JAX package's ``mobilenetv2_loss``."""
    logits, aux = model(batch["image"], key=key, keep=keep, slu_u=slu_u)
    nll = _nll(logits, batch["label"])
    one = aux["slu_cost"]
    return nll, {"loss": nll, "slu_cost": one, "slu_exec_ratio": one}
