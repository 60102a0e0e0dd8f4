"""Element-level oracles of the kernels: the ``reference`` backend.

The counterpart of the JAX package's ``kernels/ref.py``, in PyTorch on any
device.  These are what the kernels and their tile-level plain versions are
held to: the PSG weight-gradient sign decided element by element (Eq. 2)
and its *element*-level fallback ratio (the fraction of entries below the
threshold, where the kernels report the fraction of tiles); the conv by a
materialized im2col operand; attention by a materialized softmax.  They run
the JAX package's operations in its order, in fp32 where it is in fp32.

The tile-replay oracle of kernel 9's code products
(``attention_dkv_products_oracle`` in the JAX package) is
``kernels/flash_attn.flash_bwd_dkv_plain`` and is not repeated here.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.config import PSGConfig
from repro_torch.core.quant import quantize
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels.conv import (conv_grad_x_plain, conv_out_hw,
                                     conv_patches)

NEG_INF = -1e30


def quantize_ref(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quantization oracle (matches ``kernels/quant.py``)."""
    return quantize(x, bits)


def msb_of(x: torch.Tensor, bits_full: int, bits_msb: int) -> torch.Tensor:
    """The ``bits_msb`` most significant bits of a ``bits_full`` code: the
    coarser grid over the same dynamic range, i.e. ``quantize(x,
    bits_msb)``."""
    return quantize(x, bits_msb)


# ---------------------------------------------------------------------------
# PSG weight gradient
# ---------------------------------------------------------------------------


def predictor_matmul_oracle(x2: torch.Tensor, gy2: torch.Tensor,
                            cfg: PSGConfig) -> torch.Tensor:
    """The MSB predictor product ``g_msb = x_msb^T gy_msb``, fp32."""
    xm = msb_of(x2, cfg.bits_x, cfg.bits_x_msb)
    gm = msb_of(gy2, cfg.bits_g, cfg.bits_g_msb)
    return xm.float().T @ gm.float()


def predictor_confidence_ref(x2: torch.Tensor, gy2: torch.Tensor,
                             cfg: PSGConfig
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2)'s predictor state: ``(g_msb, |g_msb| >= beta *
    max|g_msb|)``."""
    g_msb = predictor_matmul_oracle(x2, gy2, cfg)
    tau = cfg.beta * g_msb.abs().amax()
    return g_msb, g_msb.abs() >= tau


def psg_grad_w_ref(x2: torch.Tensor, gy2: torch.Tensor, cfg: PSGConfig
                   ) -> torch.Tensor:
    """Element-level Eq. (2), ``x2 (N, din)``, ``gy2 (N, dout)`` -> fp32
    signs ``(din, dout)``: ``sign(g_msb)`` where the predictor is confident,
    the sign of the full 8 x 16-bit product elsewhere."""
    xq = quantize(x2, cfg.bits_x)
    gq = quantize(gy2, cfg.bits_g)
    g_full = xq.float().T @ gq.float()
    g_msb, pred_ok = predictor_confidence_ref(x2, gy2, cfg)
    return torch.where(pred_ok, torch.sign(g_msb), torch.sign(g_full))


def _fraction(mask: torch.Tensor) -> torch.Tensor:
    """The share of true entries as the JAX package's ``jnp.mean`` gives it:
    the count times ``fp32(1 / n)``."""
    inv_n = torch.full((), 1.0 / mask.numel(), dtype=torch.float32,
                       device=mask.device)
    return mask.float().sum() * inv_n


def psg_fallback_ratio_ref(x2: torch.Tensor, gy2: torch.Tensor,
                           cfg: PSGConfig) -> torch.Tensor:
    """Element-level fallback fraction: the entries the predictor could not
    decide, an fp32 0-d tensor."""
    _, pred_ok = predictor_confidence_ref(x2, gy2, cfg)
    return _fraction(~pred_ok)


def psg_grad_w_oracle(x2: torch.Tensor, gy2: torch.Tensor, cfg: PSGConfig
                      ) -> torch.Tensor:
    """The signs the tile-level kernels must give: the element-level rule
    (a confident tile emits ``sign(g_msb)``, any other uses the full
    product exactly where the element-level rule does)."""
    return psg_grad_w_ref(x2, gy2, cfg)


# ---------------------------------------------------------------------------
# conv: the materialized im2col operand
# ---------------------------------------------------------------------------


# the materialized im2col operand is the im2col conv path's own gather
conv_patches_ref = conv_patches


def conv_fwd_ref(xp: torch.Tensor, w: torch.Tensor, k: int, stride: int
                 ) -> torch.Tensor:
    """im2col + one GEMM: ``(B, Ho, Wo, dout)``."""
    B, Hp, Wp, _ = xp.shape
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    y = conv_patches_ref(xp, k, stride) @ w.to(xp.dtype)
    return y.reshape(B, ho, wo, -1)


def conv_grad_x_ref(gc: torch.Tensor, sg: torch.Tensor, wc: torch.Tensor,
                    sw: torch.Tensor, k: int, stride: int, hp: int,
                    wp: int) -> torch.Tensor:
    """Per-tap col2im scatter-add input gradient of the quantized operands
    ``gc * sg`` and ``wc * sw`` (codes and fp32 0-d scales), accumulated in
    fp32 (k*k taps summed in bf16 would lose their low bits): the same
    arithmetic as ``kernels/conv.conv_grad_x_plain``."""
    return conv_grad_x_plain(gc.float() * sg, wc.float() * sw, k, stride, hp,
                             wp)


def conv_grad_w_ref(xp: torch.Tensor, gy: torch.Tensor, cfg: PSGConfig,
                    k: int, stride: int) -> torch.Tensor:
    """Element-level PSG conv weight gradient over the im2col operand:
    ``(k*k*C, dout)`` signs."""
    return psg_grad_w_ref(conv_patches_ref(xp, k, stride),
                          gy.reshape(-1, gy.shape[-1]), cfg)


def conv_fallback_ratio_ref(xp: torch.Tensor, gy: torch.Tensor,
                            cfg: PSGConfig, k: int, stride: int
                            ) -> torch.Tensor:
    """Element-level fallback fraction over the im2col operand."""
    return psg_fallback_ratio_ref(conv_patches_ref(xp, k, stride),
                                  gy.reshape(-1, gy.shape[-1]), cfg)


# ---------------------------------------------------------------------------
# attention: the materialized softmax
# ---------------------------------------------------------------------------


def _scores_ref(q: torch.Tensor, k: torch.Tensor, causal: bool
                ) -> torch.Tensor:
    """Masked fp32 scores per query head, ``(B, nkv, S, g, T)``."""
    B, S, nh, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    qf = q.reshape(B, S, nkv, nh // nkv, hd).float()
    s = torch.einsum("bsngh,btnh->bnsgt", qf, k.float()) / math.sqrt(hd)
    if causal:
        m = torch.arange(T, device=q.device)[None, :] <= \
            torch.arange(S, device=q.device)[:, None]
        s = torch.where(m[None, None, :, None, :], s,
                        torch.full((), NEG_INF, device=q.device))
    return s


def flash_attention_oracle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """Softmax attention (GQA) in fp32, ``(B, S, nh, hd)``."""
    B, S, nh, hd = q.shape
    w = torch.softmax(_scores_ref(q, k, causal), dim=-1)
    o = torch.einsum("bnsgt,btnh->bsngh", w, v.float())
    return o.reshape(B, S, nh, hd)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Per-row logsumexp of the masked scores, ``(B, nh, S)`` fp32: the
    residual of the flash forward."""
    lse = torch.logsumexp(_scores_ref(q, k, causal), dim=-1)  # (B, nkv, S, g)
    B, nkv, S, g = lse.shape
    return lse.transpose(2, 3).reshape(B, nkv * g, S)


def flash_attention_vjp_oracle(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, do: torch.Tensor,
                               causal: bool = True
                               ) -> Tuple[torch.Tensor, ...]:
    """fp32 ``(dq, dk, dv)``: autograd through the materialized oracle."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v))
        o = flash_attention_oracle(qf, kf, vf, causal)
        return torch.autograd.grad(o, (qf, kf, vf), do.float())


def psg_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, cfg: PSGConfig,
                          causal: bool = True):
    """Element-level PSG attention backward: ``(dq, dk, dv, fallback
    ratio)``.

    dq is the exact fp32 gradient.  dk and dv apply Eq. (2) on the
    materialized probabilities and dS: each operand goes onto the grids of
    the kernels (``flash_attn.attention_psg_scales``), the predictor and full
    code products are summed over the query rows of each GQA group, and the
    shared select (``flash_attn.psg_attention_select``) takes the predictor
    value where it is confident.
    """
    B, S, nh, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    dq, _, _ = flash_attention_vjp_oracle(q, k, v, do, causal)

    p = torch.softmax(_scores_ref(q, k, causal), dim=-1)   # (B, nkv, S, g, T)
    do_r = do.reshape(B, S, nkv, g, hd).float()
    v32 = v.float()
    dp = torch.einsum("bsngh,btnh->bnsgt", do_r, v32)
    o = torch.einsum("bnsgt,btnh->bsngh", p, v32)
    delta = torch.sum(do_r * o, dim=-1)                    # (B, S, nkv, g)
    ds = p * (dp - delta.permute(0, 2, 1, 3)[..., None]) * scale

    rows = delta.reshape(B, S, nh).transpose(1, 2)         # (B, nh, S)
    s_q, s_qm, s_do, s_dom, s_ds, s_dsm = FA.attention_psg_scales(
        q, v, do, rows, bits_x=cfg.bits_x, bits_x_msb=cfg.bits_x_msb,
        bits_g=cfg.bits_g, bits_g_msb=cfg.bits_g_msb)
    lim_x, lim_xm = FA.qlim(cfg.bits_x), FA.qlim(cfg.bits_x_msb)
    lim_g, lim_gm = FA.qlim(cfg.bits_g), FA.qlim(cfg.bits_g_msb)
    q_r = q.reshape(B, S, nkv, g, hd).float()

    def prod(a, b):
        return torch.einsum("bnsgt,bsngd->btnd", a, b)

    ct = FA.codes_tile
    dv_m = prod(ct(p, 1.0 / lim_xm, lim_xm), ct(do_r, s_dom, lim_gm))
    dv_f = prod(ct(p, 1.0 / lim_x, lim_x), ct(do_r, s_do, lim_g))
    dk_m = prod(ct(ds, s_dsm, lim_gm), ct(q_r, s_qm, lim_xm))
    dk_f = prod(ct(ds, s_ds, lim_g), ct(q_r, s_q, lim_x))
    dv, r_dv = FA.psg_attention_select(dv_m, dv_f, (1.0 / lim_xm) * s_dom,
                                       (1.0 / lim_x) * s_do, cfg.beta)
    dk, r_dk = FA.psg_attention_select(dk_m, dk_f, s_dsm * s_qm, s_ds * s_q,
                                       cfg.beta)
    return dq, dk, dv, 0.5 * (r_dv + r_dk)
