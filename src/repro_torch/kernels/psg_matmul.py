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

Both run on the int8 tensor cores, one MMA kernel body with two epilogues.
Each 16-bit g code is split into two byte planes (:func:`split_code_bytes`:
``lo = g & 0xFF`` unsigned, ``hi = g >> 8`` signed, ``g = 256 hi + lo``),
and two int8 MMAs (s8 x s8 on the high plane, s8 x u8 on the low one) sum
in int32 before the kernel forms ``256 sum(x hi) + sum(x lo)`` in int64.
Each plane sums in int32 over at most ``MAX_SPLIT_TOKENS`` (65536) tokens,
where it cannot overflow for any int8 x code (``65536 * 128 * 255 <
2**31``: pass 1's 4-bit codes and pass 2's 8-bit ones alike); splits of the
token axis meet in int64 atomics.  The MMAs want the token axis
contiguous, so a pre-pass in the same call writes ``x^T`` and the two
planes of ``g^T``, zero-padded to a multiple of ``PRED_STAGE_TOKENS``
tokens, into scratch that the wrapper allocates; a three-stage
``cp.async`` ring feeds the MMAs; the token axis is split across blocks
where the output has too few tiles to fill the card or N passes 65536
tokens (:func:`predictor_matmul_split_plain` and
:func:`psg_grad_w_split_plain` are that arithmetic in plain PyTorch).

``predictor_matmul`` returns fp32, the exact integer sum rounded once, at
any N (the JAX package's pass 1 is fp32).  ``psg_grad_w`` keeps the full
product exact in integers, takes pass 1's fp32 product as its predictor
instead of recomputing it, and reads ``tau`` from device memory.  Where
the token axis is not split, the Eq. (2) select and the fallback flags run
in the MMA kernel's epilogue: no int64 product reaches device memory.
Where it is split (the qwen2.5-3b k and v projections, most ResNet im2col
widths, N past 65536), the splits meet in an int64 product that the
wrapper allocates and a select kernel runs after.  :func:`psg_full_product`
returns that int64 product alone, for the tests.  Later work: ``wgmma`` and
TMA for both.

Under a mesh each rank holds its tokens only, and a wrapper given
``reduce`` (the all-reduce of ``distributed/sharding.global_sum_int64``)
always takes the split path: the MMA kernel writes the rank's int64 sums
to device memory, ``reduce`` sums them across the ranks, exactly, and only
then does pass 1 round to fp32 and pass 2 run its select kernel (the
split path's, called on its own through ``psg_select``).

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

from repro_torch.kernels.conv import (_call, _check, _on_cuda, _reduced,
                                      _stream)

TILE = 128             # the TPU kernel's output tile, rows and columns
PRED_STAGE_TOKENS = 128  # tokens a pipeline stage of the MMA kernels
MAX_SPLIT_TOKENS = 65536  # tokens an int32 partial of the MMA kernels sums

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
    lib.psg_splits.argtypes = [_I] * 3
    lib.psg_sign.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.psg_full_product.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.psg_select.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    for fn in (lib.psg_pred, lib.psg_splits, lib.psg_sign,
               lib.psg_full_product, lib.psg_select):
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _code_product(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Exact ``x^T g`` of integer codes, as float64."""
    return x.double().T @ g.double()


def predictor_matmul_plain(xm: torch.Tensor, gm: torch.Tensor,
                           reduce=None) -> torch.Tensor:
    return _reduced(_code_product(xm, gm), reduce).to(torch.float32)


def split_code_bytes(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two byte planes of int16 codes: ``(hi int8, lo uint8)`` with
    ``g = 256 hi + lo`` for every int16 code."""
    return (g >> 8).to(torch.int8), (g & 0xFF).to(torch.uint8)


def _split_product(x: torch.Tensor, g: torch.Tensor,
                   split_tokens: int) -> torch.Tensor:
    """``256 x^T hi + x^T lo`` over the byte planes of ``g``, each plane
    summed in int32 over at most ``split_tokens`` tokens (checked: no
    partial leaves int32) and the splits added in int64."""
    hi, lo = split_code_bytes(g)
    x = x.long()
    out = torch.zeros((x.shape[1], g.shape[1]), dtype=torch.int64,
                      device=x.device)
    for n0 in range(0, x.shape[0], split_tokens):
        xs = x[n0:n0 + split_tokens].T
        ph = xs @ hi[n0:n0 + split_tokens].long()
        pl = xs @ lo[n0:n0 + split_tokens].long()
        for part in (ph, pl):
            if part.numel() and int(part.abs().max()) >= 2 ** 31:
                raise OverflowError("an int32 partial of the MMA kernels "
                                    "would overflow")
        out += 256 * ph + pl
    return out


def predictor_matmul_split_plain(xm: torch.Tensor, gm: torch.Tensor,
                                 split_tokens: int = MAX_SPLIT_TOKENS
                                 ) -> torch.Tensor:
    """The predictor kernel's arithmetic in plain PyTorch: ``256 x^T hi +
    x^T lo`` over the byte planes of ``gm``, as int64."""
    return _split_product(xm, gm, split_tokens)


def _fallback_stats(notconf: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    din, dout = notconf.shape
    bm, bn, ni, nj = tile_grid(din, dout)
    padded = (tau > 0).expand(ni * bm, nj * bn).clone()
    padded[:din, :dout] = notconf
    return padded.reshape(ni, bm, nj, bn).any(3).any(1).to(torch.int32)


def psg_select_plain(pred: torch.Tensor, full: torch.Tensor,
                     tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2) select over the predictor product and an exact full
    product (float64 or int64)."""
    pm = pred.float()
    conf = pm.abs() >= tau
    sign = torch.where(conf, torch.sign(pm).double(),
                       torch.sign(full).double())
    return sign.to(torch.int8), _fallback_stats(~conf, tau)


def psg_grad_w_plain(pred: torch.Tensor, xq: torch.Tensor, gq: torch.Tensor,
                     tau: torch.Tensor, reduce=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2) select over the predictor product and the full product."""
    return psg_select_plain(pred, _reduced(_code_product(xq, gq), reduce),
                            tau)


def mma_block(dout: int) -> Tuple[int, int]:
    """Rows and columns of the MMA kernels' output tile at this width."""
    return (128, 128) if dout >= 128 else (128, 32)


def psg_grad_w_split_plain(pred: torch.Tensor, xq: torch.Tensor,
                           gq: torch.Tensor, tau: torch.Tensor,
                           split_tokens: int = MAX_SPLIT_TOKENS
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sign kernel's arithmetic in plain PyTorch: the byte-plane product
    (:func:`predictor_matmul_split_plain`), the Eq. (2) select, and the
    flags as its fused epilogue forms them: each MMA block ORs "any element
    not confident" (a padded element of the TPU tile grid counting as not
    confident when ``tau > 0``) into the flag of the one TPU tile that
    holds it (checked).  For the tests, not on any path."""
    full = _split_product(xq, gq, split_tokens)
    din, dout = full.shape
    pm = pred.float()
    conf = pm.abs() >= tau
    sign = torch.where(conf, torch.sign(pm).long(), torch.sign(full))
    bm, bn, ni, nj = tile_grid(din, dout)
    BM, BN = mma_block(dout)
    rows, cols = -(-din // BM) * BM, -(-dout // BN) * BN
    notconf = torch.zeros((rows, cols), dtype=torch.bool)
    notconf[:ni * bm, :nj * bn] = bool(not 0.0 >= float(tau))
    notconf[:din, :dout] = ~conf
    blocks = notconf.reshape(rows // BM, BM, cols // BN, BN).any(3).any(1)
    stats = torch.zeros((ni, nj), dtype=torch.int32)
    for bi in range(rows // BM):
        for bj in range(cols // BN):
            r0, c0 = bi * BM, bj * BN
            r1 = min(r0 + BM, ni * bm) - 1
            c1 = min(c0 + BN, nj * bn) - 1
            if r0 >= ni * bm or c0 >= nj * bn:
                continue
            ti, tj = r0 // bm, c0 // bn
            if (r1 // bm, c1 // bn) != (ti, tj):
                raise AssertionError(f"MMA block {(bi, bj)} spans TPU tiles")
            stats[ti, tj] |= int(blocks[bi, bj])
    return sign.to(torch.int8), stats.to(pred.device)


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


def predictor_matmul(xm: torch.Tensor, gm: torch.Tensor,
                     reduce=None) -> torch.Tensor:
    """PSG pass 1: ``x_msb^T g_msb`` ``(din, dout)`` as fp32, the exact
    integer sum rounded once, at any token count; with ``reduce``, the
    int64 sum reduced across ranks before that rounding."""
    if not _on_cuda(xm, gm):
        return predictor_matmul_plain(xm, gm, reduce)
    N, din, dout = _check_codes(xm, gm)
    lib = _lib()
    if reduce is not None:
        full = reduce(_full_product(lib, xm, gm, N, din, dout))
        LAUNCHES["predictor_matmul"] += 1
        return full.to(torch.float32)
    n_pad, xt, gt, acc = _scratch(lib, N, din, dout, xm.device)
    out = torch.empty((din, dout), device=xm.device, dtype=torch.float32)
    _call(lib.psg_pred, xm.data_ptr(), gm.data_ptr(), xt.data_ptr(),
          gt.data_ptr(), out.data_ptr(), acc.data_ptr() if acc.numel() else 0,
          N, n_pad, din, dout, _stream(xm))
    LAUNCHES["predictor_matmul"] += 1
    return out


def _scratch(lib, N: int, din: int, dout: int, dev, force_acc=False):
    """The MMA kernels' scratch: the padded token count, x^T (din, n_pad)
    int8, the two planes of g^T (2, dout, n_pad) uint8, and the int64
    (din, dout) sums where the kernel splits the tokens (else empty)."""
    n_pad = -(-N // PRED_STAGE_TOKENS) * PRED_STAGE_TOKENS
    xt = torch.empty((din, n_pad), device=dev, dtype=torch.int8)
    gt = torch.empty((2, dout, n_pad), device=dev, dtype=torch.uint8)
    split = force_acc or lib.psg_splits(n_pad, din, dout) > 1
    acc = torch.empty((din, dout) if split else (0,), device=dev,
                      dtype=torch.int64)
    return n_pad, xt, gt, acc


def psg_grad_w(pred: torch.Tensor, xq: torch.Tensor, gq: torch.Tensor,
               tau: torch.Tensor, reduce=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG pass 2: the full 8x16-bit code product (exact in integers) and
    the Eq. (2) select against pass 1's ``pred`` at threshold ``tau`` (fp32
    0-d, read on the device); with ``reduce``, the int64 product reduced
    across ranks before the select.  Returns ``(sign (din, dout) int8,
    fallback flags (ni, nj) int32)``."""
    if not _on_cuda(pred, xq, gq, tau):
        return psg_grad_w_plain(pred, xq, gq, tau, reduce)
    N, din, dout = _check_codes(xq, gq)
    _check(pred, "pred", torch.float32, 2)
    _check(tau, "tau", torch.float32, 0)
    if pred.shape != (din, dout):
        raise ValueError(f"pred {tuple(pred.shape)} != {(din, dout)}")
    bm, bn, ni, nj = tile_grid(din, dout)
    dev = xq.device
    lib = _lib()
    sign = torch.empty((din, dout), device=dev, dtype=torch.int8)
    stats = torch.empty((ni, nj), device=dev, dtype=torch.int32)
    if reduce is not None:
        full = reduce(_full_product(lib, xq, gq, N, din, dout))
        _call(lib.psg_select, pred.data_ptr(), full.data_ptr(),
              tau.data_ptr(), sign.data_ptr(), stats.data_ptr(), din, dout,
              bm, bn, _stream(xq))
        LAUNCHES["psg_grad_w"] += 1
        return sign, stats
    n_pad, xt, gt, full = _scratch(lib, N, din, dout, dev)
    _call(lib.psg_sign, pred.data_ptr(), xq.data_ptr(), gq.data_ptr(),
          tau.data_ptr(), xt.data_ptr(), gt.data_ptr(),
          full.data_ptr() if full.numel() else 0, sign.data_ptr(),
          stats.data_ptr(), N, n_pad, din, dout, bm, bn, _stream(xq))
    LAUNCHES["psg_grad_w"] += 1
    return sign, stats


def psg_full_product(xq: torch.Tensor, gq: torch.Tensor) -> torch.Tensor:
    """The exact ``x^T g`` of 8-bit x and 16-bit g codes, int64 ``(din,
    dout)``, through the sign kernel's pre-pass and MMA kernel (CPU: the
    plain product).  For the tests and the chip smoke test, so it counts
    no launch (the wrappers run the same launches under a mesh)."""
    if not _on_cuda(xq, gq):
        return _code_product(xq, gq).to(torch.int64)
    N, din, dout = _check_codes(xq, gq)
    return _full_product(_lib(), xq, gq, N, din, dout)


def _full_product(lib, xq: torch.Tensor, gq: torch.Tensor, N: int, din: int,
                  dout: int) -> torch.Tensor:
    """The int64 code product through the pre-pass and the MMA kernel
    (pass 1's codes or pass 2's: both are int8 x and int16 g)."""
    n_pad, xt, gt, full = _scratch(lib, N, din, dout, xq.device,
                                   force_acc=True)
    _call(lib.psg_full_product, xq.data_ptr(), gq.data_ptr(), xt.data_ptr(),
          gt.data_ptr(), full.data_ptr(), N, n_pad, din, dout, _stream(xq))
    return full
