"""Predictive Sign Gradient (PSG, paper §3.3) for convolutions, dense
matmuls and self-attention.

The weight gradient leaves the backward as a sign: ``sign(g_msb)`` from a
4-bit x 10-bit predictor product where ``|g_msb| >= beta * max|g_msb|``, and
the sign of the full 8-bit x 16-bit product elsewhere (Eq. 2).  The forward
runs on the 8-bit grid and the input gradient on the 16-bit output-gradient
grid.  Convolutions run all three directions through the kernels of
``kernels/conv.py``, or, with ``fused_conv`` off, as a dense matmul of
their im2col patches; a dense matmul (:class:`PSGMatmul`) runs its forward
and input gradient as plain matmuls of the quantized operands, as the JAX
package leaves them to XLA, and its weight-gradient sign through the
kernels of ``kernels/psg_matmul.py``.  Self-attention (:class:`PSGAttention`,
under ``fused_attention=True``) runs the flash kernels of
``kernels/flash_attn.py``: an fp32 dq, and for dv and dk the Eq. (2) select
between the predictor and the full code products, as values.  Each op goes
through ``kernels/dispatch.py``, which may instead run the plain versions
or the element-level oracles (``PSGConfig.backend``); the backend is
resolved in the forward and kept for the backward.  On a mesh that shards
the parameters, with ``int8_gather``, a weight arrives as this rank's
shard (``distributed/fsdp.gathered`` marks it): the op gathers the whole
weight's int8 codes and returns the gradient of the shard.

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
from repro_torch.core.quant import codes, quantize
from repro_torch.distributed import fsdp, sharding
from repro_torch.kernels import dispatch
from repro_torch.kernels.conv import conv_out_hw, conv_patches

PROBE_SIZE = 2


def zero_probe(device=None) -> torch.Tensor:
    """A fresh probe; differentiate the loss with respect to it."""
    return torch.zeros(PROBE_SIZE, device=device, requires_grad=True)


def probe_fallback_ratio(probe_grad: torch.Tensor) -> torch.Tensor:
    """MAC-weighted measured fallback ratio from a probe gradient."""
    return probe_grad[0] / torch.clamp_min(probe_grad[1], 1.0)


def _weight_codes(w: torch.Tensor, cfg: PSGConfig, shard
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole weight's 8-bit codes and scale: of ``w``, or, where ``w``
    is this rank's ``shard = (dim, placement)`` of it (``int8_gather`` on
    a sharded mesh), gathered as codes (``distributed/fsdp.int8_gather``),
    the same codes."""
    if shard is not None:
        return fsdp.int8_gather(w, *shard, cfg.bits_x)
    return codes(w, cfg.bits_x)


def _shard_grad(sign: torch.Tensor, shard, dtype: torch.dtype
                ) -> torch.Tensor:
    """The weight gradient of ``w`` from the whole weight's sign: the sign
    itself, or, for a shard (:func:`_weight_codes`), the data axis's sum
    of the sign, which every rank computed alike (its sums are global), on
    this rank's shard: ``world`` times the shard of the sign."""
    if shard is None:
        return sign.to(dtype)
    dim, plc = shard
    return (plc.narrow(sign, dim) * plc.world).to(dtype)


class PSGConv2d(torch.autograd.Function):
    """NHWC conv ``(B, Hp, Wp, C) x (k*k*C, dout)`` with PSG backward on a
    pre-padded input (padding and the ``k < stride`` subsample stay outside,
    in :func:`conv2d`, so autograd crops ``dx`` and the quantization grids
    are those of the JAX package)."""

    @staticmethod
    def forward(ctx, xp, w, probe, k: int, stride: int, cfg: PSGConfig,
                shard=None):
        cfg = dispatch.pinned(cfg)
        ctx.k, ctx.stride, ctx.cfg = k, stride, cfg
        ctx.shard, ctx.w_dtype = shard, w.dtype
        # codes and scales of the 8-bit grid: the same grid as quantize, bit
        # for bit, handed to the kernel as int8 codes; the weight's serve
        # the input gradient too
        xc, sx = codes(xp, cfg.bits_x, sharding.global_amax(xp))
        wc, sw = _weight_codes(w, cfg, shard)
        ctx.save_for_backward(xp, wc, sw)
        return dispatch.conv_fwd(xc, sx, wc, sw, cfg, k=k, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        xp, wc, sw = ctx.saved_tensors
        k, stride, cfg = ctx.k, ctx.stride, ctx.cfg
        B, Hp, Wp, C = xp.shape
        dout = wc.shape[-1]
        ho, wo = gy.shape[1], gy.shape[2]
        dxp = None
        if ctx.needs_input_grad[0]:
            # the 16-bit grid of gy, as codes and scale: gc * sg is
            # quantize(gy, bits_g) bit for bit in fp32
            gc, sg = codes(gy, cfg.bits_g, sharding.global_amax(gy))
            dxp = dispatch.conv_grad_x(gc, sg, wc, sw, cfg, k=k,
                                       stride=stride, hp=Hp,
                                       wp=Wp).to(xp.dtype)
        sign, fallback = dispatch.conv_grad_w(xp, gy, cfg, k=k, stride=stride)
        # fp32 like the JAX package: float32(B*Ho*Wo) * (k*k*C) * dout; a
        # fill on the device, never a copy from host memory (which a captured
        # step may not hold)
        macs = torch.full((), float(B * sharding.data_world() * ho * wo),
                          dtype=torch.float32,
                          device=gy.device) * (k * k * C) * dout
        dprobe = torch.stack([fallback * macs, macs])
        return (dxp, _shard_grad(sign, ctx.shard, ctx.w_dtype), dprobe, None,
                None, None, None)


class PSGMatmul(torch.autograd.Function):
    """``(N, din) @ (din, dout)`` with PSG semantics (the JAX package's
    ``_psg_matmul``): forward ``quantize(x) @ quantize(w)`` on the 8-bit
    grid in ``x.dtype``; backward ``dx = quantize(gy, 16) @ wq^T``, ``dw``
    the kernels' sign, and the probe's ``[fallback * macs, macs]``.  Where
    ``w`` is this rank's ``shard`` of the weight (``int8_gather`` on a
    sharded mesh), ``wq`` is the whole weight's gathered codes times their
    scale, the same values; the codes are saved, so a checkpointed
    sub-block's recompute gathers them again for the backward."""

    @staticmethod
    def forward(ctx, x2, w, probe, cfg: PSGConfig, shard=None):
        ctx.cfg = dispatch.pinned(cfg)
        ctx.shard, ctx.w_dtype = shard, w.dtype
        xq = quantize(x2, cfg.bits_x, sharding.global_amax(x2))
        if shard is None:
            ctx.save_for_backward(x2, w)
            return xq @ quantize(w, cfg.bits_x).to(xq.dtype)
        wc, sw = _weight_codes(w, cfg, shard)
        ctx.save_for_backward(x2, wc, sw)
        return xq @ (wc.float() * sw).to(w.dtype).to(xq.dtype)

    @staticmethod
    def backward(ctx, gy):
        cfg = ctx.cfg
        x2, *w = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            wq = quantize(w[0], cfg.bits_x) if ctx.shard is None else \
                (w[0].float() * w[1]).to(ctx.w_dtype)
            gq = quantize(gy, cfg.bits_g, sharding.global_amax(gy))
            dx = (gq @ wq.T.to(gq.dtype)).to(x2.dtype)
        sign, fallback = dispatch.psg_grad_w(x2, gy, cfg)
        # fp32 like the JAX package: float32(N) * din * dout, N the global
        # batch's tokens
        macs = torch.full((), float(x2.shape[0] * sharding.data_world()),
                          dtype=torch.float32,
                          device=gy.device) * x2.shape[1] * gy.shape[1]
        dprobe = torch.stack([fallback * macs, macs])
        return dx, _shard_grad(sign, ctx.shard, ctx.w_dtype), dprobe, None, \
            None


class PSGAttention(torch.autograd.Function):
    """Self-attention ``(B, S, nh, hd) x (B, T, nkv, hd)`` with PSG backward
    semantics (the JAX package's ``_psg_attention``): forward the flash
    kernel, saving only ``(q, k, v, o, lse)``; backward dq, dk and dv from
    the recomputing kernels, cast to the input dtypes, and the probe's
    ``[fallback * macs, macs]`` with ``macs = 2 B nh hd`` times the score
    pairs computed (``S (S + 1) / 2`` for causal self-attention)."""

    @staticmethod
    def forward(ctx, q, k, v, probe, causal: bool, cfg: PSGConfig):
        cfg = dispatch.pinned(cfg)
        o, lse = dispatch.attention_fwd(q, k, v, cfg, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.cfg = causal, cfg
        return o

    @staticmethod
    def backward(ctx, gy):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv, fallback = dispatch.attention_bwd(
            q, k, v, o, lse, gy.to(q.dtype), ctx.cfg, causal=ctx.causal)
        B, S, nh, hd = q.shape
        T = k.shape[1]
        pairs = S * (S + 1) // 2 if (ctx.causal and S == T) else S * T
        # fp32 like the JAX package: float32(2 * B * nh * hd) * pairs
        macs = torch.full((), float(2 * B * sharding.data_world() * nh * hd),
                          dtype=torch.float32,
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


def psg_matmul(x2: torch.Tensor, w: torch.Tensor, cfg: PSGConfig,
               shard=None) -> torch.Tensor:
    """:class:`PSGMatmul` with the active probe threaded in; ``shard``
    ``(dim, placement)`` where ``w`` is this rank's shard of the weight
    (``distributed/fsdp.shard_of``)."""
    return PSGMatmul.apply(x2, w, _current_probe(x2.device), cfg, shard)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., din) @ w (din, dout)``, through PSG when a config is
    active (``w`` may be a marked shard, ``distributed/fsdp.gathered``)."""
    cfg = active_config()
    if cfg is None:
        return x @ w.to(x.dtype)
    y2 = psg_matmul(x.reshape(-1, x.shape[-1]), w, cfg, fsdp.shard_of(w))
    return y2.reshape(*x.shape[:-1], y2.shape[-1])


# where a shard's dimension lands in the 2-D weight each pattern multiplies
# by: the leading axis of a merged pair is whole blocks of its rows or
# columns, a trailing one is not (an expert pattern's per-expert weight)
_SHARD_DIM_2D = {"bsd,dnh->bsnh": {0: 0, 1: 1}, "btd,dnh->btnh": {0: 0, 1: 1},
                 "bsnh,nhd->bsd": {0: 0, 2: 1},
                 "ecd,edf->ecf": {1: 0, 2: 1}, "ecf,efd->ecd": {1: 0, 2: 1},
                 "gecd,edf->gecf": {1: 0, 2: 1},
                 "gecf,efd->gecd": {1: 0, 2: 1}}


def _shard_2d(pattern: str, shard):
    if shard is None:
        return None
    dim, plc = shard
    if dim not in _SHARD_DIM_2D[pattern]:
        raise NotImplementedError(f"psg.einsum {pattern!r} on a shard of "
                                  f"dimension {dim}")
    return _SHARD_DIM_2D[pattern][dim], plc


EINSUM_PATTERNS = ("bsd,dnh->bsnh", "btd,dnh->btnh", "bsnh,nhd->bsd",
                   "ecd,edf->ecf", "ecf,efd->ecd",
                   "gecd,edf->gecf", "gecf,efd->gecd")


def einsum(pattern: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The models' weight contractions, through PSG when a config is
    active: the attention projections ``bsd,dnh->bsnh`` (also ``btd``) and
    ``bsnh,nhd->bsd``, and the MoE experts' ``ecd,edf->ecf`` /
    ``ecf,efd->ecd`` and their grouped forms ``gecd,edf->gecf`` /
    ``gecf,efd->gecd``.  An expert pattern runs one :class:`PSGMatmul` per
    expert ``e`` on its ``(G*C, din)`` rows (the JAX package's ``vmap`` of
    ``psg_matmul``): each expert's operands get their own scales and its
    flags their own 128x128 tiling, and each adds its ``[fallback * macs,
    macs]`` to the probe.  Other patterns raise."""
    if pattern not in EINSUM_PATTERNS:
        raise NotImplementedError(f"psg.einsum pattern {pattern!r} is not "
                                  "ported")
    cfg = active_config()
    if cfg is None:
        return torch.einsum(pattern, x, w.to(x.dtype))
    # a marked shard (distributed/fsdp.gathered): the whole weight's
    # dimensions come from x, the sharded one from the product
    shard = _shard_2d(pattern, fsdp.shard_of(w))
    if pattern in ("bsd,dnh->bsnh", "btd,dnh->btnh"):
        B, S, d = x.shape
        h = w.shape[-1]
        return psg_matmul(x.reshape(B * S, d), w.reshape(w.shape[0], -1),
                          cfg, shard).reshape(B, S, -1, h)
    if pattern == "bsnh,nhd->bsd":
        B, S, n, h = x.shape
        return psg_matmul(x.reshape(B * S, n * h), w.reshape(n * h, -1),
                          cfg, shard).reshape(B, S, -1)
    # unbind, not indexing: its backward stacks the experts' gradients once,
    # where each index's would fill and add a whole-stack gradient
    ws = w.to(x.dtype).unbind(0)
    if pattern in ("ecd,edf->ecf", "ecf,efd->ecd"):
        return torch.stack([psg_matmul(xe, we, cfg, shard)
                            for xe, we in zip(x.unbind(0), ws)])
    G, E, C, din = x.shape      # each expert's rows in (g, c) order
    ys = [psg_matmul(xe.reshape(G * C, din), we, cfg,
                     shard).reshape(G, C, -1)
          for xe, we in zip(x.unbind(1), ws)]
    return torch.stack(ys).transpose(0, 1)


def fused_conv_active(cfg: Optional[PSGConfig]) -> bool:
    """Resolve a config's ``fused_conv``: no config (PSG off) is inactive,
    an explicit ``True``/``False`` wins, and ``None`` means fused (the
    port's auto since it began; the JAX package's auto picks the im2col
    path on the TPU and the fused kernels elsewhere)."""
    if cfg is None:
        return False
    return True if cfg.fused_conv is None else cfg.fused_conv


def conv2d(x: torch.Tensor, w: torch.Tensor, *, k: int = 3,
           stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` with a patch-major ``(k*k*C, dout)`` weight and SAME
    padding ``k // 2``: the one conv entry point of the models.

    When the active config's ``fused_conv`` resolves on
    (:func:`fused_conv_active`), :class:`PSGConv2d` runs the implicit-GEMM
    kernels.  Otherwise, the JAX package's materialized im2col: the padded
    input's channel-major patches times ``w`` through :func:`matmul`, which
    is the PSG matmul kernels under a config and a plain product with PSG
    off (JAX ``models/resnet.conv2d`` and ``core/psg.conv2d``'s
    ``conv_fwd_ref``, the same product).

    ``k < stride`` (the 1x1 stride-2 shortcut) is a pre-subsampled stride-1
    conv: its im2col patches are the subsample, so the quantization grid is
    the same on both paths.
    """
    cfg = active_config()
    if k < stride:
        x = x[:, ::stride, ::stride, :]
        stride = 1
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    if not fused_conv_active(cfg):
        ho, wo = conv_out_hw(xp.shape[1], xp.shape[2], k, stride)
        y = matmul(conv_patches(xp, k, stride), w)
        return y.reshape(xp.shape[0], ho, wo, -1)
    return PSGConv2d.apply(xp, w, _current_probe(xp.device), k, stride, cfg,
                           fsdp.shard_of(w))


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
