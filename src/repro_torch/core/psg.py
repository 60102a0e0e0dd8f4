"""Predictive Sign Gradient (PSG, paper §3.3) for convolutions, dense
matmuls and self-attention.

The weight gradient leaves the backward as a sign: ``sign(g_msb)`` from a
4-bit x 10-bit predictor product where ``|g_msb| >= beta * max|g_msb|``, and
the sign of the full 8-bit x 16-bit product elsewhere (Eq. 2).  The forward
runs on the 8-bit grid and the input gradient on the 16-bit output-gradient
grid.  Convolutions run all three directions through the kernels of
``kernels/conv.py``; a dense matmul (:class:`PSGMatmul`) runs its forward
and input gradient as plain matmuls of the quantized operands, as the JAX
package leaves them to XLA, and its weight-gradient sign through the
kernels of ``kernels/psg_matmul.py``.  Self-attention (:class:`PSGAttention`,
under ``fused_attention=True``) runs the flash kernels of
``kernels/flash_attn.py``: an fp32 dq, and for dv and dk the Eq. (2) select
between the predictor and the full code products, as values.

The backward also reports how often the full product was needed, through
the gradient of a *probe*: a ``zeros(2)`` tensor that requires grad and is
an input of every PSG op.  Each op's backward returns ``[fallback * macs,
macs]`` as the probe's gradient, autograd sums them, and
:func:`probe_fallback_ratio` turns the sum into the MAC-weighted fallback
ratio of the step.  A block that SLU skips runs no op and adds nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import PSGConfig
from repro_torch.core.quant import quantize
from repro_torch.kernels import ops

PROBE_SIZE = 2


def zero_probe(device=None) -> torch.Tensor:
    """A fresh probe; differentiate the loss with respect to it."""
    return torch.zeros(PROBE_SIZE, device=device, requires_grad=True)


def probe_fallback_ratio(probe_grad: torch.Tensor) -> torch.Tensor:
    """MAC-weighted measured fallback ratio from a probe gradient."""
    return probe_grad[0] / torch.clamp_min(probe_grad[1], 1.0)


class PSGConv2d(torch.autograd.Function):
    """NHWC conv ``(B, Hp, Wp, C) x (k*k*C, dout)`` with PSG backward on a
    pre-padded input (padding and the ``k < stride`` subsample stay outside,
    in :func:`conv2d`, so autograd crops ``dx`` and the quantization grids
    are those of the JAX package)."""

    @staticmethod
    def forward(ctx, xp, w, probe, k: int, stride: int, cfg: PSGConfig):
        ctx.save_for_backward(xp, w)
        ctx.k, ctx.stride, ctx.cfg = k, stride, cfg
        xq = quantize(xp, cfg.bits_x)
        wq = quantize(w, cfg.bits_x).to(xq.dtype)
        return ops.conv_fwd(xq, wq, k, stride)

    @staticmethod
    def backward(ctx, gy):
        xp, w = ctx.saved_tensors
        k, stride, cfg = ctx.k, ctx.stride, ctx.cfg
        B, Hp, Wp, C = xp.shape
        dout = w.shape[-1]
        ho, wo = gy.shape[1], gy.shape[2]
        dxp = None
        if ctx.needs_input_grad[0]:
            gq = quantize(gy, cfg.bits_g)
            wq = quantize(w, cfg.bits_x)
            dxp = ops.conv_grad_x(gq, wq, k, stride, Hp, Wp).to(xp.dtype)
        sign, fallback = ops.conv_grad_w(xp, gy, cfg, k, stride)
        # fp32 like the JAX package: float32(B*Ho*Wo) * (k*k*C) * dout
        macs = torch.tensor(float(B * ho * wo), dtype=torch.float32,
                            device=gy.device) * (k * k * C) * dout
        dprobe = torch.stack([fallback * macs, macs])
        return dxp, sign.to(w.dtype), dprobe, None, None, None


class PSGMatmul(torch.autograd.Function):
    """``(N, din) @ (din, dout)`` with PSG semantics (the JAX package's
    ``_psg_matmul``): forward ``quantize(x) @ quantize(w)`` on the 8-bit
    grid in ``x.dtype``; backward ``dx = quantize(gy, 16) @ wq^T``, ``dw``
    the kernels' sign, and the probe's ``[fallback * macs, macs]``."""

    @staticmethod
    def forward(ctx, x2, w, probe, cfg: PSGConfig):
        ctx.save_for_backward(x2, w)
        ctx.cfg = cfg
        xq = quantize(x2, cfg.bits_x)
        return xq @ quantize(w, cfg.bits_x).to(xq.dtype)

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        cfg = ctx.cfg
        dx = None
        if ctx.needs_input_grad[0]:
            gq = quantize(gy, cfg.bits_g)
            dx = (gq @ quantize(w, cfg.bits_x).T.to(gq.dtype)).to(x2.dtype)
        sign, fallback = ops.psg_grad_w(x2, gy, cfg)
        # fp32 like the JAX package: float32(N) * din * dout
        macs = torch.tensor(float(x2.shape[0]), dtype=torch.float32,
                            device=gy.device) * x2.shape[1] * gy.shape[1]
        dprobe = torch.stack([fallback * macs, macs])
        return dx, sign.to(w.dtype), dprobe, None


class PSGAttention(torch.autograd.Function):
    """Self-attention ``(B, S, nh, hd) x (B, T, nkv, hd)`` with PSG backward
    semantics (the JAX package's ``_psg_attention``): forward the flash
    kernel, saving only ``(q, k, v, o, lse)``; backward dq, dk and dv from
    the recomputing kernels, cast to the input dtypes, and the probe's
    ``[fallback * macs, macs]`` with ``macs = 2 B nh hd`` times the score
    pairs computed (``S (S + 1) / 2`` for causal self-attention)."""

    @staticmethod
    def forward(ctx, q, k, v, probe, causal: bool, cfg: PSGConfig):
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.cfg = causal, cfg
        return o

    @staticmethod
    def backward(ctx, gy):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv, fallback = ops.flash_attention_bwd(
            q, k, v, o, lse, gy.to(q.dtype), ctx.cfg, causal=ctx.causal)
        B, S, nh, hd = q.shape
        T = k.shape[1]
        pairs = S * (S + 1) // 2 if (ctx.causal and S == T) else S * T
        # fp32 like the JAX package: float32(2 * B * nh * hd) * pairs
        macs = torch.tensor(float(2 * B * nh * hd), dtype=torch.float32,
                            device=gy.device) * pairs
        dprobe = torch.stack([fallback * macs, macs])
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dprobe, None,
                None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """:class:`PSGAttention` under the active config, with the active probe
    threaded in; callers gate on ``config.fused_attention_active``."""
    cfg = active_config()
    if cfg is None:
        raise ValueError("psg.attention needs an active PSG config "
                         "(psg.enable)")
    return PSGAttention.apply(q, k, v, _current_probe(q.device), causal, cfg)


def psg_matmul(x2: torch.Tensor, w: torch.Tensor, cfg: PSGConfig
               ) -> torch.Tensor:
    """:class:`PSGMatmul` with the active probe threaded in."""
    return PSGMatmul.apply(x2, w, _current_probe(x2.device), cfg)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., din) @ w (din, dout)``, through PSG when a config is
    active."""
    cfg = active_config()
    if cfg is None:
        return x @ w.to(x.dtype)
    y2 = psg_matmul(x.reshape(-1, x.shape[-1]), w, cfg)
    return y2.reshape(*x.shape[:-1], w.shape[-1])


def einsum(pattern: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dense attention projections, through PSG when a config is
    active: ``bsd,dnh->bsnh`` (q/k/v) and ``bsnh,nhd->bsd`` (output).
    Other patterns raise (the JAX package's grouped MoE patterns are not
    ported)."""
    if pattern not in ("bsd,dnh->bsnh", "bsnh,nhd->bsd"):
        raise NotImplementedError(f"psg.einsum pattern {pattern!r} is not "
                                  "ported")
    cfg = active_config()
    if cfg is None:
        return torch.einsum(pattern, x, w.to(x.dtype))
    if pattern == "bsd,dnh->bsnh":
        B, S, d = x.shape
        _, n, h = w.shape
        return psg_matmul(x.reshape(B * S, d), w.reshape(d, n * h),
                          cfg).reshape(B, S, n, h)
    B, S, n, h = x.shape
    d = w.shape[-1]
    return psg_matmul(x.reshape(B * S, n * h), w.reshape(n * h, d),
                      cfg).reshape(B, S, d)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, k: int = 3,
           stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` with a patch-major ``(k*k*C, dout)`` weight and SAME
    padding ``k // 2``.

    Runs :class:`PSGConv2d` under the active PSG config; without one it
    raises (training without PSG needs the materialized im2col path, which
    this package does not have).

    ``k < stride`` (the 1x1 stride-2 shortcut) is a pre-subsampled stride-1
    conv, so the quantization grid is that of the subsample.
    """
    cfg = active_config()
    if cfg is None:
        raise NotImplementedError("conv2d needs an active PSG config "
                                  "(psg.enable); the non-PSG conv path is "
                                  "not ported")
    if k < stride:
        x = x[:, ::stride, ::stride, :]
        stride = 1
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    return PSGConv2d.apply(xp, w, _current_probe(xp.device), k, stride, cfg)


# ---------------------------------------------------------------------------
# the active config, per thread
# ---------------------------------------------------------------------------

_state = threading.local()


def active_config() -> Optional[PSGConfig]:
    cfg = getattr(_state, "cfg", None)
    return cfg if (cfg is not None and cfg.enabled) else None


def _current_probe(device) -> torch.Tensor:
    probe = getattr(_state, "probe", None)
    return probe if probe is not None else torch.zeros(PROBE_SIZE,
                                                       device=device)


def snapshot() -> Tuple[Optional[PSGConfig], Optional[torch.Tensor]]:
    """The ``(cfg, probe)`` of the current context, to re-enter it with
    :func:`enable` where the context is gone: the recompute of a
    checkpointed block runs in the backward, outside it."""
    return getattr(_state, "cfg", None), getattr(_state, "probe", None)


@contextlib.contextmanager
def enable(cfg: Optional[PSGConfig], probe: Optional[torch.Tensor] = None):
    """Route convs and model matmuls through PSG inside this context,
    threading ``probe`` (see :func:`zero_probe`) into each of them."""
    prev = getattr(_state, "cfg", None), getattr(_state, "probe", None)
    _state.cfg, _state.probe = cfg, probe
    try:
        yield
    finally:
        _state.cfg, _state.probe = prev
