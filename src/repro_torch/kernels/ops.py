"""Conv and matmul ops on the kernels, as the PSG autograd functions call
them.

The counterpart of the JAX package's ``kernels/ops.py`` (conv and PSG
matmul parts) and ``kernels/dispatch.py``.  There is one backend choice and
it is made by the tensors' device inside each wrapper of ``kernels/conv.py``
and ``kernels/psg_matmul.py``: CPU tensors take the plain PyTorch version,
CUDA tensors launch the kernel.  No environment variable and no fallback
are involved.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.config import PSGConfig
from repro_torch.core.quant import codes
from repro_torch.kernels import conv as K
from repro_torch.kernels import psg_matmul as PM


def _lim(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def conv_fwd(xq: torch.Tensor, wq: torch.Tensor, k: int,
             stride: int) -> torch.Tensor:
    """Conv forward on pre-quantized, pre-padded NHWC input and a
    patch-major weight."""
    return K.conv_fwd(xq.float().contiguous(), wq.float().contiguous(), k,
                      stride)


def conv_grad_x(gq: torch.Tensor, wq: torch.Tensor, k: int, stride: int,
                hp: int, wp: int) -> torch.Tensor:
    """Input gradient on pre-quantized operands, ``(B, hp, wp, C)`` fp32."""
    return K.conv_grad_x(gq.float().contiguous(), wq.float().contiguous(), k,
                         stride, hp, wp)


def conv_grad_w(xp: torch.Tensor, gy: torch.Tensor, cfg: PSGConfig, k: int,
                stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG weight-gradient sign and the measured fallback ratio.

    Codes are built here with the same ops as the plain versions; pass 1
    gives the predictor product, ``tau = beta * max|g_msb|`` stays on the
    device, pass 2 selects.  Returns ``(sign (k*k*C, dout) fp32 in {-1, 0,
    1}, mean of the per-(tap, dout block) fallback flags as an fp32 0-d
    tensor)``.
    """
    xm, _ = codes(xp, cfg.bits_x_msb)
    gm, _ = codes(gy, cfg.bits_g_msb)
    xq, _ = codes(xp, cfg.bits_x)
    gq, _ = codes(gy, cfg.bits_g)
    xm, gm, xq, gq = (t.contiguous() for t in (xm, gm, xq, gq))
    pred = K.conv_grad_w_predictor(xm, gm, k, stride,
                                   x_lim=_lim(cfg.bits_x_msb),
                                   g_lim=_lim(cfg.bits_g_msb))
    tau = cfg.beta * pred.float().abs().amax()
    sign, stats = K.conv_grad_w(pred, xq, gq, tau, k, stride)
    return sign.float(), stats.float().mean()


def psg_grad_w(x2: torch.Tensor, gy2: torch.Tensor, cfg: PSGConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG weight-gradient sign of ``x2 (N, din) @ w`` from the output
    gradient ``gy2 (N, dout)``, and the measured fallback ratio.

    The operands are cast to fp32 before the codes are built, as the JAX
    package's dispatch layer does.  Pass 1 gives the predictor product,
    ``tau = beta * max|g_msb|`` stays on the device, pass 2 selects.
    Returns ``(sign (din, dout) fp32 in {-1, 0, 1}, mean of the per-tile
    fallback flags as an fp32 0-d tensor)``.
    """
    x2, gy2 = x2.float(), gy2.float()
    xm, _ = codes(x2, cfg.bits_x_msb)
    gm, _ = codes(gy2, cfg.bits_g_msb)
    xq, _ = codes(x2, cfg.bits_x)
    gq, _ = codes(gy2, cfg.bits_g)
    xm, gm, xq, gq = (t.contiguous() for t in (xm, gm, xq, gq))
    pred = PM.predictor_matmul(xm, gm, x_lim=_lim(cfg.bits_x_msb),
                               g_lim=_lim(cfg.bits_g_msb))
    tau = cfg.beta * pred.float().abs().amax()
    sign, stats = PM.psg_grad_w(pred, xq, gq, tau)
    return sign.float(), stats.float().mean()
