"""Implicit-GEMM convolution kernels and the PSG weight-gradient sign.

Four CUDA kernels (``csrc/conv.cu``), each behind a wrapper with a plain
PyTorch version beside it.  A wrapper given CPU tensors computes the plain
version; given CUDA tensors it launches its kernel or raises.  Each launch
adds one to ``LAUNCHES[<wrapper name>]``.

Layouts are the JAX package's: NHWC activations, pre-padded by the caller,
and patch-major ``(k*k*C, dout)`` weights (row ``c*k*k + ki*k + kj``).

=====================  ===============================================
wrapper                replaces (JAX package, ``kernels/conv.py``)
=====================  ===============================================
conv_fwd               ``conv_fwd_pallas`` / ``_conv_fwd_kernel``
conv_grad_x            ``conv_grad_x_pallas`` / ``_conv_grad_x_kernel``
conv_grad_w_predictor  ``conv_grad_w_predictor_pallas`` / ``_conv_pred_kernel``
conv_grad_w            ``conv_grad_w_pallas`` / ``_conv_grad_w_kernel``
=====================  ===============================================

What bounds them on an H100, and what the design does about it:

* ``conv_fwd`` / ``conv_grad_x``: fp32 operands on the CUDA cores, one
  thread per output element; at ResNet widths the least time is set by the
  operation count at the fp32 rate.  No im2col tensor exists: the gather is
  index arithmetic.  ``conv_grad_x`` is the gather form of the transposed
  conv, so it needs no atomics and is deterministic.
* ``conv_grad_w_predictor`` / ``conv_grad_w``: integer code products
  reduced over ``B*Ho*Wo`` positions; bound by operations.  The reduction is
  split across blocks that meet in integer atomics, which are exact, so the
  result does not depend on the order.  Pass 2 takes pass 1's product as its
  predictor instead of recomputing it, and reads ``tau`` from device memory:
  no host round trip between the passes.

The plain versions accumulate kernels 1 and 2 in fp32, and multiply the
integer codes of kernels 3 and 4 as float64, which is exact below 2**53
(the ResNet-74 batch-128 sums stay below 6e11), so kernel and plain version
agree bit for bit there.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

FALLBACK_BLOCK = 128   # dout block of one fallback flag (the TPU kernels' tile)

LAUNCHES: Dict[str, int] = {"conv_fwd": 0, "conv_grad_x": 0,
                            "conv_grad_w_predictor": 0, "conv_grad_w": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def conv_out_hw(hp: int, wp: int, k: int, stride: int) -> Tuple[int, int]:
    """VALID output extent of a pre-padded ``(Hp, Wp)`` input."""
    return (hp - k) // stride + 1, (wp - k) // stride + 1


def conv_patches(xp: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Materialized im2col of a pre-padded NHWC input: ``(B*Ho*Wo,
    k*k*C)``, channel-major like the weights (feature ``c*k*k + ki*k +
    kj``), the layout of the JAX package's
    ``conv_general_dilated_patches``.  The operand of the im2col conv path;
    the kernels above gather their patches in-kernel instead."""
    B, Hp, Wp, C = xp.shape
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    taps = [xp[:, ki:ki + (ho - 1) * stride + 1:stride,
               kj:kj + (wo - 1) * stride + 1:stride, :]
            for ki in range(k) for kj in range(k)]
    return torch.stack(taps, dim=-1).reshape(B * ho * wo, C * k * k)


def fallback_blocks(dout: int) -> Tuple[int, int]:
    """(block width, block count) of the per-tap fallback flags."""
    bn_ = min(FALLBACK_BLOCK, dout)
    return bn_, -(-dout // bn_)


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("conv")
    lib.conv_fwd.argtypes = [_P, _P, _P] + [_I] * 9 + [_P]
    lib.conv_grad_x.argtypes = [_P, _P, _P] + [_I] * 9 + [_P]
    lib.conv_grad_w_pred.argtypes = [_P, _P, _P] + [_I] * 9 + [_P]
    lib.conv_grad_w_sign.argtypes = [_P] * 7 + [_I] * 11 + [_P]
    for fn in (lib.conv_fwd, lib.conv_grad_x, lib.conv_grad_w_pred,
               lib.conv_grad_w_sign):
        fn.restype = ctypes.c_int
    return lib


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises on anything else."""
    kinds = {t.device for t in ts}
    if len(kinds) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, kinds))}")
    kind = next(iter(kinds)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no conv kernel for device type {kind!r}")
    return kind == "cuda"


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _call(fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"CUDA error {err} from {fn.__name__}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _window(x: torch.Tensor, ki: int, kj: int, stride: int,
            ho: int, wo: int) -> torch.Tensor:
    return x[:, ki:ki + (ho - 1) * stride + 1:stride,
             kj:kj + (wo - 1) * stride + 1:stride, :]


def conv_fwd_plain(xp: torch.Tensor, w: torch.Tensor, k: int,
                   stride: int) -> torch.Tensor:
    """fp32 tap loop ``sum_t window_t(xp) @ w_t``."""
    B, Hp, Wp, C = xp.shape
    dout = w.shape[-1]
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    wt = w.float().reshape(C, k, k, dout)
    y = xp.new_zeros((B, ho, wo, dout), dtype=torch.float32)
    for ki in range(k):
        for kj in range(k):
            y += _window(xp.float(), ki, kj, stride, ho, wo) @ wt[:, ki, kj]
    return y


def conv_grad_x_plain(gq: torch.Tensor, wq: torch.Tensor, k: int, stride: int,
                      hp: int, wp: int) -> torch.Tensor:
    """fp32 per-tap scatter-add of ``gy @ w_t^T`` into the padded input."""
    B, ho, wo, dout = gq.shape
    C = wq.shape[0] // (k * k)
    wt = wq.float().reshape(C, k, k, dout)
    dx = gq.new_zeros((B, hp, wp, C), dtype=torch.float32)
    for ki in range(k):
        for kj in range(k):
            _window(dx, ki, kj, stride, ho, wo).add_(
                gq.float() @ wt[:, ki, kj].T)
    return dx


def _code_product(x: torch.Tensor, g: torch.Tensor, k: int,
                  stride: int) -> torch.Tensor:
    """Exact ``sum_n window(x)^T g`` of integer codes, as float64,
    patch-major ``(k*k*C, dout)``."""
    B, Hp, Wp, C = x.shape
    dout = g.shape[-1]
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    x64, g64 = x.double(), g.double().reshape(-1, dout)
    out = x64.new_empty((C, k, k, dout))
    for ki in range(k):
        for kj in range(k):
            out[:, ki, kj] = _window(x64, ki, kj, stride, ho, wo) \
                .reshape(-1, C).T @ g64
    return out.reshape(k * k * C, dout)


def conv_grad_w_predictor_plain(xm: torch.Tensor, gm: torch.Tensor, k: int,
                                stride: int) -> torch.Tensor:
    return _code_product(xm, gm, k, stride).to(torch.int32)


def _fallback_stats(notconf: torch.Tensor, tau: torch.Tensor,
                    k: int) -> torch.Tensor:
    """One flag per (tap, dout block); columns padded up to a whole block
    count as fallback when ``tau > 0`` (they hold ``g_msb = 0``)."""
    rows, dout = notconf.shape
    C = rows // (k * k)
    bn_, nj = fallback_blocks(dout)
    nc = notconf.reshape(C, k * k, dout)
    pad = nj * bn_ - dout
    if pad:
        nc = torch.cat([nc, (tau > 0).expand(C, k * k, pad)], dim=-1)
    return nc.reshape(C, k * k, nj, bn_).any(3).any(0).to(torch.int32)


def conv_grad_w_plain(pred: torch.Tensor, xq: torch.Tensor, gq: torch.Tensor,
                      tau: torch.Tensor, k: int, stride: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2) select over the predictor product and the full product."""
    full = _code_product(xq, gq, k, stride)
    pm = pred.float()
    conf = pm.abs() >= tau
    sign = torch.where(conf, torch.sign(pm).double(), torch.sign(full))
    return sign.to(torch.int8), _fallback_stats(~conf, tau, k)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def conv_fwd(xp: torch.Tensor, w: torch.Tensor, k: int,
             stride: int) -> torch.Tensor:
    """``(B, Hp, Wp, C)`` fp32 x ``(k*k*C, dout)`` fp32 -> ``(B, Ho, Wo,
    dout)`` fp32."""
    if not _on_cuda(xp, w):
        return conv_fwd_plain(xp, w, k, stride)
    _check(xp, "xp", torch.float32, 4)
    _check(w, "w", torch.float32, 2)
    B, Hp, Wp, C = xp.shape
    if w.shape[0] != k * k * C:
        raise ValueError(f"w has {w.shape[0]} rows, expected {k * k * C}")
    dout = w.shape[1]
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    y = torch.empty((B, ho, wo, dout), device=xp.device, dtype=torch.float32)
    lib = _lib()
    _call(lib.conv_fwd, xp.data_ptr(), w.data_ptr(), y.data_ptr(), B, Hp, Wp,
          C, dout, k, stride, ho, wo, _stream(xp))
    LAUNCHES["conv_fwd"] += 1
    return y


def conv_grad_x(gq: torch.Tensor, wq: torch.Tensor, k: int, stride: int,
                hp: int, wp: int) -> torch.Tensor:
    """``(B, Ho, Wo, dout)`` fp32 x ``(k*k*C, dout)`` fp32 -> ``dx (B, hp,
    wp, C)`` fp32, the gradient of :func:`conv_fwd` with respect to its
    padded input."""
    if not _on_cuda(gq, wq):
        return conv_grad_x_plain(gq, wq, k, stride, hp, wp)
    _check(gq, "gq", torch.float32, 4)
    _check(wq, "wq", torch.float32, 2)
    B, ho, wo, dout = gq.shape
    C = wq.shape[0] // (k * k)
    if wq.shape != (k * k * C, dout) or conv_out_hw(hp, wp, k, stride) != (ho, wo):
        raise ValueError(f"inconsistent shapes gq {tuple(gq.shape)}, wq "
                         f"{tuple(wq.shape)}, k={k}, stride={stride}, "
                         f"input {hp}x{wp}")
    # (k*k, dout, C): the layout the kernel reads with coalesced loads
    wt = wq.reshape(C, k * k, dout).permute(1, 2, 0).contiguous()
    dx = torch.empty((B, hp, wp, C), device=gq.device, dtype=torch.float32)
    lib = _lib()
    _call(lib.conv_grad_x, gq.data_ptr(), wt.data_ptr(), dx.data_ptr(), B, ho,
          wo, dout, C, k, stride, hp, wp, _stream(gq))
    LAUNCHES["conv_grad_x"] += 1
    return dx


def _check_codes(x: torch.Tensor, g: torch.Tensor, k: int, stride: int
                 ) -> Tuple[int, int, int, int, int, int, int]:
    _check(x, "x codes", torch.int8, 4)
    _check(g, "g codes", torch.int16, 4)
    B, Hp, Wp, C = x.shape
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    if g.shape[:3] != (B, ho, wo):
        raise ValueError(f"g codes {tuple(g.shape)} do not match the output "
                         f"extent {(B, ho, wo)} of x codes {tuple(x.shape)}")
    return B, Hp, Wp, C, ho, wo, g.shape[3]


def conv_grad_w_predictor(xm: torch.Tensor, gm: torch.Tensor, k: int,
                          stride: int, x_lim: int = 7, g_lim: int = 511
                          ) -> torch.Tensor:
    """PSG pass 1: ``sum_n window(x_msb)^T g_msb`` as int32, patch-major.
    ``x_lim``/``g_lim`` bound the code magnitudes; the call raises when the
    sum could overflow int32."""
    if not _on_cuda(xm, gm):
        return conv_grad_w_predictor_plain(xm, gm, k, stride)
    B, Hp, Wp, C, ho, wo, dout = _check_codes(xm, gm, k, stride)
    if B * ho * wo * x_lim * g_lim >= 2 ** 31:
        raise ValueError("predictor product could overflow int32")
    out = torch.empty((k * k * C, dout), device=xm.device, dtype=torch.int32)
    lib = _lib()
    _call(lib.conv_grad_w_pred, xm.data_ptr(), gm.data_ptr(), out.data_ptr(),
          B, Hp, Wp, C, ho, wo, dout, k, stride, _stream(xm))
    LAUNCHES["conv_grad_w_predictor"] += 1
    return out


def conv_grad_w(pred: torch.Tensor, xq: torch.Tensor, gq: torch.Tensor,
                tau: torch.Tensor, k: int, stride: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG pass 2: the full 8x16-bit code product (int64) and the Eq. (2)
    select against pass 1's ``pred`` at threshold ``tau`` (fp32 0-d, read on
    the device).  Returns ``(sign (k*k*C, dout) int8 patch-major, fallback
    flags (k*k, ceil(dout/128)) int32)``."""
    if not _on_cuda(pred, xq, gq, tau):
        return conv_grad_w_plain(pred, xq, gq, tau, k, stride)
    B, Hp, Wp, C, ho, wo, dout = _check_codes(xq, gq, k, stride)
    _check(pred, "pred", torch.int32, 2)
    _check(tau, "tau", torch.float32, 0)
    if pred.shape != (k * k * C, dout):
        raise ValueError(f"pred {tuple(pred.shape)} != {(k * k * C, dout)}")
    bn_, nj = fallback_blocks(dout)
    dev = xq.device
    full = torch.empty((k * k * C, dout), device=dev, dtype=torch.int64)
    sign = torch.empty((k * k * C, dout), device=dev, dtype=torch.int8)
    stats = torch.empty((k * k, nj), device=dev, dtype=torch.int32)
    lib = _lib()
    _call(lib.conv_grad_w_sign, pred.data_ptr(), xq.data_ptr(), gq.data_ptr(),
          tau.data_ptr(), full.data_ptr(), sign.data_ptr(), stats.data_ptr(),
          B, Hp, Wp, C, ho, wo, dout, k, stride, bn_, nj, _stream(xq))
    LAUNCHES["conv_grad_w"] += 1
    return sign, stats
