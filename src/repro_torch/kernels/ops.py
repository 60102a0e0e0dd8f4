"""Quantize, conv, matmul and attention ops on the kernels: the
tile-level ops of the ``plain`` and ``cuda`` backends.

The counterpart of the JAX package's ``kernels/ops.py``.  Which backend runs
is decided by ``kernels/dispatch.py``, which the PSG autograd functions
call; the element-level ``reference`` backend is ``kernels/ref.py``.  Each
op here calls the wrappers of ``kernels/{quant,conv,psg_matmul,
flash_attn}.py``, which launch their kernels on CUDA tensors and compute the
plain PyTorch versions on CPU tensors; ``plain=True`` calls the plain
versions directly, on either device.  No environment variable and no
fallback are involved.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.config import PSGConfig
from repro_torch.core.quant import codes, qscale
from repro_torch.distributed import sharding
from repro_torch.kernels import conv as K
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import psg_matmul as PM
from repro_torch.kernels import quant as Q


def quantize(x: torch.Tensor, bits: int, plain: bool = False) -> torch.Tensor:
    """Fake-quantize ``x`` (fp32 or bf16) on its per-tensor grid."""
    if plain:
        return Q.quantize_plain(x, qscale(x, bits), bits)
    return Q.quantize(x, bits)


def conv_fwd(xc: torch.Tensor, sx: torch.Tensor, wc: torch.Tensor,
             sw: torch.Tensor, k: int, stride: int,
             plain: bool = False) -> torch.Tensor:
    """Conv forward on the codes and scales of a pre-padded NHWC input and
    a patch-major weight: the conv of ``xc * sx`` and ``wc * sw``."""
    if plain:
        return K.conv_fwd_plain(xc.float() * sx, wc.float() * sw, k, stride)
    return K.conv_fwd(xc.contiguous(), sx, wc.contiguous(), sw, k, stride)


def conv_grad_x(gc: torch.Tensor, sg: torch.Tensor, wc: torch.Tensor,
                sw: torch.Tensor, k: int, stride: int, hp: int, wp: int,
                plain: bool = False) -> torch.Tensor:
    """Input gradient on the codes and scales of the output gradient and of
    a patch-major weight: ``(B, hp, wp, C)`` fp32, the transposed conv of
    ``gc * sg`` and ``wc * sw``."""
    if plain:
        return K.conv_grad_x_plain(gc.float() * sg, wc.float() * sw, k,
                                   stride, hp, wp)
    return K.conv_grad_x(gc.contiguous(), sg, wc.contiguous(), sw, k, stride,
                         hp, wp)


def conv_grad_w(xp: torch.Tensor, gy: torch.Tensor, cfg: PSGConfig, k: int,
                stride: int, plain: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG weight-gradient sign and the measured fallback ratio.

    Codes are built here with the same ops as the plain versions; pass 1
    gives the predictor product, ``tau = beta * max|g_msb|`` stays on the
    device, pass 2 selects.  Under a mesh (``distributed/sharding``) the
    grids are the global batch's and both passes' int64 sums over the
    positions are summed across ranks before pass 1's fp32 rounding and
    before the select, so every rank gets the global signs and flags.
    Returns ``(sign (k*k*C, dout) fp32 in {-1, 0, 1}, mean of the
    per-(tap, dout block) fallback flags as an fp32 0-d tensor)``.
    """
    xm, gm, xq, gq = _wgrad_codes(xp, gy, cfg)
    reduce = sharding.int64_reducer()
    if plain:
        pred = K.conv_grad_w_predictor_plain(xm, gm, k, stride, reduce)
    else:
        pred = K.conv_grad_w_predictor(xm, gm, k, stride, reduce)
    tau = cfg.beta * pred.float().abs().amax()
    select = K.conv_grad_w_plain if plain else K.conv_grad_w
    sign, stats = select(pred, xq, gq, tau, k, stride, reduce)
    return sign.float(), stats.float().mean()


def _wgrad_codes(x: torch.Tensor, gy: torch.Tensor, cfg: PSGConfig
                 ) -> Tuple[torch.Tensor, ...]:
    """The four contiguous code tensors of the two PSG passes: x and gy on
    their MSB grids and on their full grids (the global batch's grids
    under a mesh)."""
    ax, ag = sharding.global_amax(x), sharding.global_amax(gy)
    xm, _ = codes(x, cfg.bits_x_msb, ax)
    gm, _ = codes(gy, cfg.bits_g_msb, ag)
    xq, _ = codes(x, cfg.bits_x, ax)
    gq, _ = codes(gy, cfg.bits_g, ag)
    return tuple(t.contiguous() for t in (xm, gm, xq, gq))


def psg_grad_w(x2: torch.Tensor, gy2: torch.Tensor, cfg: PSGConfig,
               plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG weight-gradient sign of ``x2 (N, din) @ w`` from the output
    gradient ``gy2 (N, dout)``, and the measured fallback ratio.

    The operands are cast to fp32 before the codes are built, as the JAX
    package's dispatch layer does.  Pass 1 gives the predictor product,
    ``tau = beta * max|g_msb|`` stays on the device, pass 2 selects; under
    a mesh as :func:`conv_grad_w`.
    Returns ``(sign (din, dout) fp32 in {-1, 0, 1}, mean of the per-tile
    fallback flags as an fp32 0-d tensor)``.
    """
    xm, gm, xq, gq = _wgrad_codes(x2.float(), gy2.float(), cfg)
    reduce = sharding.int64_reducer()
    if plain:
        pred = PM.predictor_matmul_plain(xm, gm, reduce)
    else:
        pred = PM.predictor_matmul(xm, gm, reduce)
    tau = cfg.beta * pred.float().abs().amax()
    select = PM.psg_grad_w_plain if plain else PM.psg_grad_w
    sign, stats = select(pred, xq, gq, tau, reduce)
    return sign.float(), stats.float().mean()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, plain: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward and the logsumexp residual: q ``(B, S, nh,
    hd)``, k/v ``(B, T, nkv, hd)`` -> ``(o in q.dtype, lse (B, nh, S)
    fp32)``; the kernel writes no ``(S, T)`` tensor to device memory."""
    fn = FA.flash_attention_plain if plain else FA.flash_fwd
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        cfg: PSGConfig, causal: bool = True,
                        plain: bool = False):
    """PSG flash-attention backward: ``(dq, dk, dv, fallback ratio)``.

    In order: ``delta = rowsum(dO * O)`` in fp32; dq from kernel 8; the six
    grid scales; the group-summed code products from kernel 9; the Eq. (2)
    select of dv and of dk (values, and the fraction of 128-row kv tiles
    that fell back); the ratio is the mean of the two.  dq, dk and dv are
    fp32.
    """
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    delta = torch.einsum("bsnh,bsnh->bns", do.float(), o.float()).contiguous()
    bwd_dq = FA.flash_bwd_dq_plain if plain else FA.flash_bwd_dq
    bwd_dkv = FA.flash_bwd_dkv_plain if plain else FA.flash_bwd_dkv
    dq = bwd_dq(q, k, v, do, lse, delta, causal=causal)
    scales = FA.attention_psg_scales(
        q, v, do, delta, bits_x=cfg.bits_x, bits_x_msb=cfg.bits_x_msb,
        bits_g=cfg.bits_g, bits_g_msb=cfg.bits_g_msb)
    lims = (FA.qlim(cfg.bits_x), FA.qlim(cfg.bits_x_msb),
            FA.qlim(cfg.bits_g), FA.qlim(cfg.bits_g_msb))
    dv_m, dv_f, dk_m, dk_f = bwd_dkv(q, k, v, do, lse, delta, scales,
                                     lims=lims, causal=causal)
    s_q, s_qm, s_do, s_dom, s_ds, s_dsm = scales
    dv, r_dv = FA.psg_attention_select(dv_m.float(), dv_f.float(),
                                       (1.0 / lims[1]) * s_dom,
                                       (1.0 / lims[0]) * s_do, cfg.beta)
    dk, r_dk = FA.psg_attention_select(dk_m.float(), dk_f.float(),
                                       s_dsm * s_qm, s_ds * s_q, cfg.beta)
    return dq, dk, dv, 0.5 * (r_dv + r_dk)
