"""The two PSG weight-gradient kernels of a dense matmul.

Two CUDA kernels (``csrc/psg_matmul.cu``), each behind a wrapper with a
plain PyTorch version beside it.  A wrapper given CPU tensors computes the
plain version; given CUDA tensors it launches its kernel or raises.  Each
launch adds one to ``LAUNCHES[<wrapper name>]``.

For ``y = x @ w`` with ``x (N, din)`` and ``gy (N, dout)`` the kernels take
integer codes (``kernels/ops.py`` builds them) and reduce over the N tokens:

================  ====================================================
wrapper           replaces (JAX package, ``kernels/psg_matmul.py``)
================  ====================================================
predictor_matmul  ``predictor_matmul_pallas`` / ``_pred_kernel``
psg_grad_w        ``psg_grad_w_pallas`` / ``_psg_kernel``
================  ====================================================

What bounds them on an H100, and what the design does about it: integer
code products, bound by their operations (counted at the int8 rate) at the
token counts of LM training.

``predictor_matmul`` runs on the int8 tensor cores.  Each 16-bit g code is
split into two byte planes (:func:`split_code_bytes`: ``lo = g & 0xFF``
unsigned, ``hi = g >> 8`` signed, ``g = 256 hi + lo``), and two int8 MMAs
(s8 x s8 on the high plane, s8 x u8 on the low one) sum in int32 before the
kernel forms ``256 sum(x hi) + sum(x lo)`` (:func:`predictor_matmul_split_plain`
is that arithmetic in plain PyTorch).  Each plane sums in int32 over at most
65536 tokens, where it cannot overflow; the two combine in int64, splits of
the token axis meet in int64 atomics, and the output is fp32, the exact
integer sum rounded once, at any N (the JAX package's pass 1 is fp32).
The MMAs want the token axis contiguous, so a pre-pass in the same call
writes ``x^T`` and the two planes of ``g^T``, zero-padded to a multiple of
``PRED_STAGE_TOKENS`` tokens, into scratch that the wrapper allocates; a
three-stage ``cp.async`` ring feeds the MMAs; the token axis is split across
blocks where the output has too few tiles to fill the card or N passes
65536 tokens.

``psg_grad_w`` stays on the CUDA cores: a 128 x 128 output tile per block,
the token axis split across blocks that meet in integer atomics, which are
exact, so the result does not depend on the order.  It sums the 8-bit x
16-bit product in int32 over at most 512 tokens and in int64 beyond, takes
pass 1's fp32 product as its predictor instead of recomputing it, and
reads ``tau`` from device memory.  Later work: ``psg_grad_w`` on the int8
tensor cores with the same byte planes; ``wgmma`` and TMA for both.

The fallback flags follow the TPU kernel's tiling whatever the CUDA tiling
is: one flag per ``min(128, din) x min(128, dout)`` tile of the padded
grid; a partly padded tile counts as fallback whenever ``tau > 0``, since
its padded ``g_msb`` is 0.

The plain versions multiply the codes as float64, which is exact below
2**53 (the qwen2.5-3b sums at N = 8192 stay below 3.5e10); pass 1 then
rounds that exact sum to fp32 once, as the kernel does, so kernel and plain
version agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels.conv import _call, _check, _on_cuda, _stream

TILE = 128             # the TPU kernel's output tile, rows and columns
PRED_STAGE_TOKENS = 128  # tokens a pipeline stage of the predictor kernel

LAUNCHES: Dict[str, int] = {"predictor_matmul": 0, "psg_grad_w": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tile_grid(din: int, dout: int) -> Tuple[int, int, int, int]:
    """``(bm, bn, ni, nj)``: the fallback tile and the tile counts."""
    bm, bn = min(TILE, din), min(TILE, dout)
    return bm, bn, -(-din // bm), -(-dout // bn)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("psg_matmul")
    lib.psg_pred.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    lib.psg_pred_splits.argtypes = [_I] * 3
    lib.psg_sign.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    for fn in (lib.psg_pred, lib.psg_pred_splits, lib.psg_sign):
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _code_product(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Exact ``x^T g`` of integer codes, as float64."""
    return x.double().T @ g.double()


def predictor_matmul_plain(xm: torch.Tensor, gm: torch.Tensor) -> torch.Tensor:
    return _code_product(xm, gm).to(torch.float32)


def split_code_bytes(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two byte planes of int16 codes: ``(hi int8, lo uint8)`` with
    ``g = 256 hi + lo`` for every int16 code."""
    return (g >> 8).to(torch.int8), (g & 0xFF).to(torch.uint8)


def predictor_matmul_split_plain(xm: torch.Tensor,
                                 gm: torch.Tensor) -> torch.Tensor:
    """The predictor kernel's arithmetic in plain PyTorch: ``256 x^T hi +
    x^T lo`` over the byte planes of ``gm``, as int64."""
    hi, lo = split_code_bytes(gm)
    x = xm.long()
    return 256 * (x.T @ hi.long()) + x.T @ lo.long()


def _fallback_stats(notconf: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    din, dout = notconf.shape
    bm, bn, ni, nj = tile_grid(din, dout)
    padded = (tau > 0).expand(ni * bm, nj * bn).clone()
    padded[:din, :dout] = notconf
    return padded.reshape(ni, bm, nj, bn).any(3).any(1).to(torch.int32)


def psg_grad_w_plain(pred: torch.Tensor, xq: torch.Tensor, gq: torch.Tensor,
                     tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2) select over the predictor product and the full product."""
    full = _code_product(xq, gq)
    pm = pred.float()
    conf = pm.abs() >= tau
    sign = torch.where(conf, torch.sign(pm).double(), torch.sign(full))
    return sign.to(torch.int8), _fallback_stats(~conf, tau)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_codes(x: torch.Tensor, g: torch.Tensor) -> Tuple[int, int, int]:
    _check(x, "x codes", torch.int8, 2)
    _check(g, "g codes", torch.int16, 2)
    if x.shape[0] != g.shape[0]:
        raise ValueError(f"x codes {tuple(x.shape)} and g codes "
                         f"{tuple(g.shape)} differ in the token count")
    return x.shape[0], x.shape[1], g.shape[1]


def predictor_matmul(xm: torch.Tensor, gm: torch.Tensor) -> torch.Tensor:
    """PSG pass 1: ``x_msb^T g_msb`` ``(din, dout)`` as fp32, the exact
    integer sum rounded once, at any token count."""
    if not _on_cuda(xm, gm):
        return predictor_matmul_plain(xm, gm)
    N, din, dout = _check_codes(xm, gm)
    n_pad = -(-N // PRED_STAGE_TOKENS) * PRED_STAGE_TOKENS
    dev = xm.device
    lib = _lib()
    out = torch.empty((din, dout), device=dev, dtype=torch.float32)
    xt = torch.empty((din, n_pad), device=dev, dtype=torch.int8)
    gt = torch.empty((2, dout, n_pad), device=dev, dtype=torch.uint8)
    # int64 sums of the token splits, where the kernel splits the tokens
    acc = torch.empty((din, dout) if lib.psg_pred_splits(n_pad, din, dout) > 1
                      else (0,), device=dev, dtype=torch.int64)
    _call(lib.psg_pred, xm.data_ptr(), gm.data_ptr(), xt.data_ptr(),
          gt.data_ptr(), out.data_ptr(), acc.data_ptr() if acc.numel() else 0,
          N, n_pad, din, dout, _stream(xm))
    LAUNCHES["predictor_matmul"] += 1
    return out


def psg_grad_w(pred: torch.Tensor, xq: torch.Tensor, gq: torch.Tensor,
               tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG pass 2: the full 8x16-bit code product (int64) and the Eq. (2)
    select against pass 1's ``pred`` at threshold ``tau`` (fp32 0-d, read
    on the device).  Returns ``(sign (din, dout) int8, fallback flags (ni,
    nj) int32)``."""
    if not _on_cuda(pred, xq, gq, tau):
        return psg_grad_w_plain(pred, xq, gq, tau)
    N, din, dout = _check_codes(xq, gq)
    _check(pred, "pred", torch.float32, 2)
    _check(tau, "tau", torch.float32, 0)
    if pred.shape != (din, dout):
        raise ValueError(f"pred {tuple(pred.shape)} != {(din, dout)}")
    bm, bn, ni, nj = tile_grid(din, dout)
    dev = xq.device
    full = torch.empty((din, dout), device=dev, dtype=torch.int64)
    sign = torch.empty((din, dout), device=dev, dtype=torch.int8)
    stats = torch.empty((ni, nj), device=dev, dtype=torch.int32)
    _call(_lib().psg_sign, pred.data_ptr(), xq.data_ptr(), gq.data_ptr(),
          tau.data_ptr(), full.data_ptr(), sign.data_ptr(), stats.data_ptr(),
          N, din, dout, bm, bn, _stream(xq))
    LAUNCHES["psg_grad_w"] += 1
    return sign, stats
