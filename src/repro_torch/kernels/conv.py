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

* ``conv_fwd`` takes the operands as integer codes and their two fp32
  scales.  8-bit codes run an int8 implicit GEMM on the tensor cores: the
  block stages its input rows plus halo once and runs every tap from shared
  memory, sums ``cx cw`` exactly in int32 and multiplies by ``sx sw`` once
  (:func:`conv_fwd_codes_plain` is that arithmetic in PyTorch); it reads a
  quarter of the bytes of fp32 operands and is bound by its bytes.  Wider
  codes (int16) run the fp32 CUDA-core kernel on ``cx sx`` and ``cw sw``;
  the codes' dtype picks the kernel.
* ``conv_grad_x`` takes the int16 output-gradient codes and the weight
  codes with their two fp32 scales.  8-bit weight codes run an int8
  implicit GEMM on the tensor cores, one stride phase a block: every tap of
  a phase reads g at a constant shift of the phase's lattice, so the block
  stages its g rows plus halo once; the 16-bit g codes go in as two byte
  planes (``g = 256 hi + lo``), each summed exactly in int32, and ``256 hi
  + lo`` meets in int64, is rounded once to fp32 and multiplied by ``sg
  sw`` (:func:`conv_grad_x_codes_plain` is that arithmetic in PyTorch).
  It is the gather form of the transposed conv: no atomics, deterministic,
  bound by its bytes.  Wider weight codes (int16) run the fp32 CUDA-core
  kernel on ``gc sg`` and ``wc sw``, one thread per dx element; the weight
  codes' dtype picks the kernel.
* ``conv_grad_w_predictor`` runs on the int8 tensor cores: a pre-pass writes
  the x codes channel-major on a padded grid (per stride phase) and the two
  byte planes of the g codes (``g = 256 hi + lo``) on the same grid, where
  every tap is a constant shift of the position (:func:`pred_grid`,
  :func:`conv_grad_w_predictor_grid_plain` is that arithmetic in PyTorch);
  a block stages one chunk of positions once for all taps.  The sums are
  exact integers at any size (int32 partials over at most 65536 positions,
  int64 across them) and come out as fp32, rounded once, as the JAX
  package's fp32 pass 1.
* ``conv_grad_w`` runs kernel 3's pre-pass and MMA body on the 8-bit x
  codes and the 16-bit g codes (each byte plane's int32 sum exact over the
  65,536 positions of a split, the splits meeting in int64 atomics, which
  are exact and order-free), then a select kernel runs the Eq. (2) select
  and the flags (:func:`conv_grad_w_grid_plain` is that arithmetic in
  PyTorch).  It takes pass 1's fp32 product as its predictor instead of
  recomputing it, and reads ``tau`` from device memory: no host round trip
  between the passes.
* Under a mesh each rank holds its positions only: kernels 3 and 4, given
  ``reduce`` (the all-reduce of ``distributed/sharding.global_sum_int64``),
  stop after the MMA kernel with the rank's int64 sums in their scratch
  (``conv_grad_w_sums``), ``reduce`` sums them across the ranks, exactly,
  and only then does pass 1 round to fp32 and pass 2 run its select kernel
  (``conv_grad_w_select``).

The plain versions accumulate kernels 1 and 2 in fp32 on the scaled codes
(the operands the JAX package's kernels take), and multiply the integer
codes of kernels 3 and 4 as float64, which is exact below 2**53 (the
ResNet-74 batch-128 sums stay below 6e11); pass 1 rounds its exact sum to
fp32 once, as the kernel does, so kernels 3 and 4 and their plain versions
agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.cost import patch_extraction

FALLBACK_BLOCK = 128   # dout block of one fallback flag (the TPU kernels' tile)
PRED_BLOCK = 256       # positions of a weight-gradient pre-pass block
# positions a split of the weight-gradient kernels sums at most: each byte
# plane's int32 partial stays exact (65536 * 127 * 255 < 2**31)
MAX_SPLIT_POSITIONS = 65536
FWD_K_STEP = 32        # K bytes an MMA step of the forward and dx kernels

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
    with patch_extraction():       # data movement for the static audit
        taps = [xp[:, ki:ki + (ho - 1) * stride + 1:stride,
                   kj:kj + (wo - 1) * stride + 1:stride, :]
                for ki in range(k) for kj in range(k)]
        return torch.stack(taps, dim=-1).reshape(B * ho * wo, C * k * k)


def pred_grid(hp: int, wp: int, k: int, stride: int) -> Tuple[int, int, int]:
    """``(Hq, Wq, halo)`` of the predictor kernel's padded grid: each stride
    phase of the padded input is an ``Hq x Wq`` grid, the output gradient
    sits at its top left, and tap ``(ki, kj)`` reads phase ``(ki % s, kj %
    s)`` shifted by ``(ki // s) * Wq + kj // s`` positions, at most
    ``halo``."""
    hq, wq = -(-hp // stride), -(-wp // stride)
    a = (k - 1) // stride
    return hq, wq, a * wq + a


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
    lib.conv_fwd_codes.argtypes = [_P] * 6 + [_I] * 12 + [_P]
    lib.conv_grad_x.argtypes = [_P, _P, _P] + [_I] * 9 + [_P]
    lib.conv_grad_x_codes.argtypes = [_P] * 6 + [_I] * 12 + [_P]
    lib.conv_grad_w_pred.argtypes = [_P] * 4 + [_I] * 13 + [_P]
    lib.conv_grad_w_sign.argtypes = [_P] * 7 + [_I] * 15 + [_P]
    lib.conv_grad_w_sums.argtypes = [_P] * 3 + [_I] * 14 + [_P]
    lib.conv_grad_w_select.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    for fn in (lib.conv_fwd, lib.conv_fwd_codes, lib.conv_grad_x,
               lib.conv_grad_x_codes, lib.conv_grad_w_pred,
               lib.conv_grad_w_sign, lib.conv_grad_w_sums,
               lib.conv_grad_w_select):
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


def conv_fwd_codes_plain(xc: torch.Tensor, sx: torch.Tensor,
                         wc: torch.Tensor, sw: torch.Tensor, k: int,
                         stride: int) -> torch.Tensor:
    """The forward kernel's arithmetic on 8-bit codes: ``(sum_t
    window_t(xc) @ wc_t)`` summed exactly (float64, exact below 2**53, as
    the kernel's int32 sum is exact), rounded to fp32 and multiplied by the
    fp32 ``sx * sw``.  Bit-identical to the kernel."""
    B, Hp, Wp, C = xc.shape
    dout = wc.shape[-1]
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    w64 = wc.double().reshape(C, k, k, dout)
    acc = xc.new_zeros((B, ho, wo, dout), dtype=torch.float64)
    for ki in range(k):
        for kj in range(k):
            win = _window(xc.double(), ki, kj, stride, ho, wo)
            acc += win @ w64[:, ki, kj]
    return acc.float() * (sx * sw)


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


def conv_grad_x_codes_plain(gc: torch.Tensor, sg: torch.Tensor,
                            wc: torch.Tensor, sw: torch.Tensor, k: int,
                            stride: int, hp: int, wp: int) -> torch.Tensor:
    """The input-gradient kernel's arithmetic on int16 g codes and 8-bit
    weight codes: the per-tap scatter-add of ``gc @ wc_t^T`` summed exactly
    (float64, exact below 2**53, as the kernel's int32 byte-plane sums and
    their int64 ``256 hi + lo`` are exact), rounded to fp32 once and
    multiplied by the fp32 ``sg * sw``.  Bit-identical to the kernel."""
    B, ho, wo, dout = gc.shape
    C = wc.shape[0] // (k * k)
    w64 = wc.double().reshape(C, k, k, dout)
    acc = gc.new_zeros((B, hp, wp, C), dtype=torch.float64)
    for ki in range(k):
        for kj in range(k):
            _window(acc, ki, kj, stride, ho, wo).add_(
                gc.double() @ w64[:, ki, kj].T)
    return acc.float() * (sg * sw)


def conv_grad_x_k_bytes(k: int, stride: int, dout: int) -> int:
    """K bytes of the dx kernel's largest stride phase, ``(0, 0)``: its
    ``ceil(k / s)**2`` taps times dout rounded up to 16, rounded up to the
    32-byte MMA step.  Each byte plane sums in int32 over at most this many
    products, which stays exact below 65,536."""
    taps = (-(-k // stride)) ** 2
    return -(-taps * -(-dout // 16) * 16 // FWD_K_STEP) * FWD_K_STEP


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


def _reduced(p: torch.Tensor, reduce) -> torch.Tensor:
    """An exact float64 code product, summed across ranks by ``reduce``
    in int64 where given."""
    return p if reduce is None else reduce(p.to(torch.int64))


def conv_grad_w_predictor_plain(xm: torch.Tensor, gm: torch.Tensor, k: int,
                                stride: int, reduce=None) -> torch.Tensor:
    return _reduced(_code_product(xm, gm, k, stride),
                    reduce).to(torch.float32)


def _grid_product(x: torch.Tensor, g: torch.Tensor, k: int, stride: int,
                  split: int = MAX_SPLIT_POSITIONS) -> torch.Tensor:
    """The weight-gradient kernels' product: the x codes of each stride
    phase and the byte planes of the g codes (``hi = g >> 8``, ``lo = g &
    0xFF``) on the padded grid of :func:`pred_grid`, every tap a shifted
    view of one phase, each plane summed over at most ``split`` grid
    positions (checked: every such partial fits the kernels' int32) and
    ``256 x^T hi + x^T lo`` summed exactly (float64, exact below 2**53),
    patch-major ``(k*k*C, dout)``."""
    B, Hp, Wp, C = x.shape
    dout = g.shape[-1]
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    hq, wq, halo = pred_grid(Hp, Wp, k, stride)
    q = B * hq * wq
    gg = g.new_zeros((B, hq, wq, dout))
    gg[:, :ho, :wo] = g
    gg = gg.reshape(q, dout)
    hi, lo = (gg >> 8).double(), (gg & 0xFF).double()
    phases = {}
    for pi in range(stride):
        for pj in range(stride):
            ph = x[:, pi::stride, pj::stride]
            grid = x.new_zeros((B, hq, wq, C))
            grid[:, :ph.shape[1], :ph.shape[2]] = ph
            flat = grid.reshape(q, C).double()
            phases[pi, pj] = torch.cat([flat, flat.new_zeros((halo, C))])
    out = torch.zeros((C, k, k, dout), dtype=torch.float64, device=x.device)
    for ki in range(k):
        for kj in range(k):
            shift = (ki // stride) * wq + kj // stride
            xs = phases[ki % stride, kj % stride][shift:shift + q]
            for n0 in range(0, q, split):
                xt = xs[n0:n0 + split].T
                ph_hi, ph_lo = xt @ hi[n0:n0 + split], xt @ lo[n0:n0 + split]
                for part in (ph_hi, ph_lo):
                    if part.numel() and float(part.abs().max()) >= 2 ** 31:
                        raise OverflowError("an int32 plane partial of the "
                                            "weight-gradient kernels would "
                                            "overflow")
                out[:, ki, kj] += 256 * ph_hi + ph_lo
    return out.reshape(k * k * C, dout)


def conv_grad_w_predictor_grid_plain(xm: torch.Tensor, gm: torch.Tensor,
                                     k: int, stride: int) -> torch.Tensor:
    """The predictor kernel's arithmetic: :func:`_grid_product` rounded to
    fp32 once."""
    return _grid_product(xm, gm, k, stride).to(torch.float32)


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


def _select(pred: torch.Tensor, full: torch.Tensor, tau: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2): ``sign(pred)`` where ``|pred| >= tau``, else
    ``sign(full)``; returns the int8 signs and the confident mask."""
    pm = pred.float()
    conf = pm.abs() >= tau
    sign = torch.where(conf, torch.sign(pm).double(),
                       torch.sign(full).double())
    return sign.to(torch.int8), conf


def conv_grad_w_plain(pred: torch.Tensor, xq: torch.Tensor, gq: torch.Tensor,
                      tau: torch.Tensor, k: int, stride: int, reduce=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2) select over the predictor product and the full product."""
    sign, conf = _select(pred, _reduced(_code_product(xq, gq, k, stride),
                                        reduce), tau)
    return sign, _fallback_stats(~conf, tau, k)


def conv_grad_w_grid_plain(pred: torch.Tensor, xq: torch.Tensor,
                           gq: torch.Tensor, tau: torch.Tensor, k: int,
                           stride: int, split: int = MAX_SPLIT_POSITIONS
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sign kernel's arithmetic: :func:`_grid_product` on the 8-bit x
    and 16-bit g codes (each byte plane's partial over at most ``split``
    grid positions checked against int32), then the Eq. (2) select and the
    flags of the select kernel.  For the tests, not on any path."""
    sign, conf = _select(pred, _grid_product(xq, gq, k, stride, split), tau)
    return sign, _fallback_stats(~conf, tau, k)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def conv_fwd(xc: torch.Tensor, sx: torch.Tensor, wc: torch.Tensor,
             sw: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``(B, Hp, Wp, C)`` codes with scale ``sx`` x ``(k*k*C, dout)`` codes
    with scale ``sw`` -> ``(B, Ho, Wo, dout)`` fp32: the conv of the
    quantized operands ``xc * sx`` and ``wc * sw`` (the scales fp32 0-d
    tensors).  int8 codes run the int8 tensor-core kernel, int16 codes the
    fp32 kernel."""
    if not _on_cuda(xc, sx, wc, sw):
        return conv_fwd_plain(xc.float() * sx, wc.float() * sw, k, stride)
    if xc.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"xc: expected int8 or int16 codes, got {xc.dtype}")
    _check(xc, "xc", xc.dtype, 4)
    _check(wc, "wc", xc.dtype, 2)
    _check(sx, "sx", torch.float32, 0)
    _check(sw, "sw", torch.float32, 0)
    B, Hp, Wp, C = xc.shape
    if wc.shape[0] != k * k * C:
        raise ValueError(f"wc has {wc.shape[0]} rows, expected {k * k * C}")
    dout = wc.shape[1]
    ho, wo = conv_out_hw(Hp, Wp, k, stride)
    y = torch.empty((B, ho, wo, dout), device=xc.device, dtype=torch.float32)
    lib = _lib()
    if xc.dtype == torch.int16:
        xq = (xc.float() * sx).contiguous()
        wq = (wc.float() * sw).contiguous()
        _call(lib.conv_fwd, xq.data_ptr(), wq.data_ptr(), y.data_ptr(), B, Hp,
              Wp, C, dout, k, stride, ho, wo, _stream(xc))
    else:
        if wo > 128:
            raise ValueError(f"output width {wo}: the int8 conv kernel takes "
                             "at most 128")
        # scratch for the kernel's tap-major w^T (dout, k*k*C), zero-padded
        # to whole dout tiles and to a multiple of the 32-byte K step
        kp = -(-k * k * C // FWD_K_STEP) * FWD_K_STEP
        bn = 16 if dout <= 16 else 32 if dout <= 32 else 64
        wt = torch.empty((-(-dout // bn) * bn, kp), device=xc.device,
                         dtype=torch.int8)
        _call(lib.conv_fwd_codes, xc.data_ptr(), wc.data_ptr(), wt.data_ptr(),
              sx.data_ptr(), sw.data_ptr(), y.data_ptr(), B, Hp, Wp, C, dout,
              k, stride, ho, wo, kp, bn, int(xc.data_ptr() % 16 == 0),
              _stream(xc))
    LAUNCHES["conv_fwd"] += 1
    return y


def conv_grad_x(gc: torch.Tensor, sg: torch.Tensor, wc: torch.Tensor,
                sw: torch.Tensor, k: int, stride: int, hp: int,
                wp: int) -> torch.Tensor:
    """``(B, Ho, Wo, dout)`` g codes with scale ``sg`` x ``(k*k*C, dout)``
    weight codes with scale ``sw`` -> ``dx (B, hp, wp, C)`` fp32, the
    gradient of :func:`conv_fwd` with respect to its padded input, on the
    quantized operands ``gc * sg`` and ``wc * sw`` (the scales fp32 0-d
    tensors).  int8 weight codes run the int8 tensor-core kernel on the g
    codes' byte planes (int8 g codes are widened to int16), int16 weight
    codes the fp32 kernel."""
    if not _on_cuda(gc, sg, wc, sw):
        return conv_grad_x_plain(gc.float() * sg, wc.float() * sw, k, stride,
                                 hp, wp)
    if gc.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"gc: expected int8 or int16 codes, got {gc.dtype}")
    if wc.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"wc: expected int8 or int16 codes, got {wc.dtype}")
    _check(gc, "gc", gc.dtype, 4)
    _check(wc, "wc", wc.dtype, 2)
    _check(sg, "sg", torch.float32, 0)
    _check(sw, "sw", torch.float32, 0)
    B, ho, wo, dout = gc.shape
    C = wc.shape[0] // (k * k)
    if wc.shape != (k * k * C, dout) or conv_out_hw(hp, wp, k, stride) != (ho, wo):
        raise ValueError(f"inconsistent shapes gc {tuple(gc.shape)}, wc "
                         f"{tuple(wc.shape)}, k={k}, stride={stride}, "
                         f"input {hp}x{wp}")
    dx = torch.empty((B, hp, wp, C), device=gc.device, dtype=torch.float32)
    lib = _lib()
    if wc.dtype == torch.int16:
        gq = (gc.float() * sg).contiguous()
        # (k*k, dout, C): the layout the kernel reads with coalesced loads
        wt = (wc.float() * sw).reshape(C, k * k, dout).permute(1, 2, 0) \
            .contiguous()
        _call(lib.conv_grad_x, gq.data_ptr(), wt.data_ptr(), dx.data_ptr(), B,
              ho, wo, dout, C, k, stride, hp, wp, _stream(gc))
    else:
        if -(-wp // stride) > 128:
            raise ValueError(f"input width {wp} at stride {stride}: the int8 "
                             "conv dx kernel takes at most 128 positions a "
                             "phase row")
        kp = conv_grad_x_k_bytes(k, stride, dout)
        if kp > 65536:
            raise ValueError(f"k={k}, stride={stride}, dout={dout}: {kp} K "
                             "bytes a phase, past the 65536 that keep the "
                             "int32 byte-plane sums exact")
        gc = gc.to(torch.int16)
        bn = 16 if C <= 16 else 32 if C <= 32 else 64
        rows = -(-C // bn) * bn
        # scratch for the kernel's phase weights (s*s, rows, kp)
        wt = torch.empty((stride * stride, rows, kp), device=gc.device,
                         dtype=torch.int8)
        _call(lib.conv_grad_x_codes, gc.data_ptr(), wc.data_ptr(),
              wt.data_ptr(), sg.data_ptr(), sw.data_ptr(), dx.data_ptr(), B,
              ho, wo, dout, C, k, stride, hp, wp, kp, rows,
              int(gc.data_ptr() % 16 == 0), _stream(gc))
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


def _wgrad_scratch(x: torch.Tensor, B: int, Hp: int, Wp: int, C: int,
                   dout: int, k: int, stride: int
                   ) -> Tuple[torch.Tensor, int, int, int, int]:
    """Scratch of the weight-gradient kernels, in one allocation, with
    ``(Hq, Wq, Np, NpX)`` of their padded grid.  The layout
    (``WgradScratch`` in ``csrc/conv.cu``): the int64 sums, padded to 128
    bytes, then the x copies ``(s*s, C, NpX)`` and the g planes ``(2,
    dout, Np)``."""
    if k > 3:
        raise ValueError(f"k={k}: the weight-gradient kernels take kernels up "
                         "to 3x3")
    hq, wq, halo = pred_grid(Hp, Wp, k, stride)
    n_pad = max(1, -(-B * hq * wq // PRED_BLOCK)) * PRED_BLOCK
    # x rows reach a chunk plus its halo (and one word) past the last stage
    x_pad = -(-(n_pad + halo + 4 + 15) // PRED_BLOCK) * PRED_BLOCK
    acc = -(-8 * k * k * C * dout // 128) * 128
    scratch = torch.empty(acc + stride * stride * C * x_pad
                          + 2 * dout * n_pad, device=x.device,
                          dtype=torch.uint8)
    return scratch, hq, wq, n_pad, x_pad


def _wgrad_sums(x: torch.Tensor, g: torch.Tensor, dims, k: int,
                stride: int, sign_pass: bool, reduce) -> torch.Tensor:
    """The int64 sums ``(k*k*C, dout)`` of one pass (its pre-passes and MMA
    kernel), reduced across ranks by ``reduce``."""
    B, Hp, Wp, C, ho, wo, dout = dims
    scratch, hq, wq, n_pad, x_pad = _wgrad_scratch(x, B, Hp, Wp, C, dout, k,
                                                   stride)
    _call(_lib().conv_grad_w_sums, x.data_ptr(), g.data_ptr(),
          scratch.data_ptr(), int(sign_pass), B, Hp, Wp, C, ho, wo, dout, k,
          stride, hq, wq, n_pad, x_pad, _stream(x))
    acc = scratch[:8 * k * k * C * dout].view(torch.int64)
    return reduce(acc.view(k * k * C, dout))


def conv_grad_w_predictor(xm: torch.Tensor, gm: torch.Tensor, k: int,
                          stride: int, reduce=None) -> torch.Tensor:
    """PSG pass 1: ``sum_n window(x_msb)^T g_msb`` patch-major ``(k*k*C,
    dout)`` as fp32, the exact integer sum rounded once, at any size; with
    ``reduce``, the int64 sum reduced across ranks before that rounding."""
    if not _on_cuda(xm, gm):
        return conv_grad_w_predictor_plain(xm, gm, k, stride, reduce)
    B, Hp, Wp, C, ho, wo, dout = dims = _check_codes(xm, gm, k, stride)
    if reduce is not None:
        acc = _wgrad_sums(xm, gm, dims, k, stride, False, reduce)
        LAUNCHES["conv_grad_w_predictor"] += 1
        return acc.to(torch.float32)
    scratch, hq, wq, n_pad, x_pad = _wgrad_scratch(xm, B, Hp, Wp, C, dout, k,
                                                   stride)
    out = torch.empty((k * k * C, dout), device=xm.device, dtype=torch.float32)
    _call(_lib().conv_grad_w_pred, xm.data_ptr(), gm.data_ptr(),
          scratch.data_ptr(), out.data_ptr(), B, Hp, Wp, C, ho, wo, dout, k,
          stride, hq, wq, n_pad, x_pad, _stream(xm))
    LAUNCHES["conv_grad_w_predictor"] += 1
    return out


def conv_grad_w(pred: torch.Tensor, xq: torch.Tensor, gq: torch.Tensor,
                tau: torch.Tensor, k: int, stride: int, reduce=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG pass 2: the full 8x16-bit code product (exact) and the Eq. (2)
    select against pass 1's fp32 ``pred`` at threshold ``tau`` (fp32 0-d,
    read on the device); with ``reduce``, the int64 product reduced across
    ranks before the select.  Returns ``(sign (k*k*C, dout) int8
    patch-major, fallback flags (k*k, ceil(dout/128)) int32)``."""
    if not _on_cuda(pred, xq, gq, tau):
        return conv_grad_w_plain(pred, xq, gq, tau, k, stride, reduce)
    B, Hp, Wp, C, ho, wo, dout = dims = _check_codes(xq, gq, k, stride)
    _check(pred, "pred", torch.float32, 2)
    _check(tau, "tau", torch.float32, 0)
    if pred.shape != (k * k * C, dout):
        raise ValueError(f"pred {tuple(pred.shape)} != {(k * k * C, dout)}")
    bn_, nj = fallback_blocks(dout)
    sign = torch.empty((k * k * C, dout), device=xq.device, dtype=torch.int8)
    stats = torch.empty((k * k, nj), device=xq.device, dtype=torch.int32)
    if reduce is not None:
        acc = _wgrad_sums(xq, gq, dims, k, stride, True, reduce)
        _call(_lib().conv_grad_w_select, pred.data_ptr(), acc.data_ptr(),
              tau.data_ptr(), sign.data_ptr(), stats.data_ptr(), k * k * C,
              dout, k * k, bn_, nj, _stream(xq))
        LAUNCHES["conv_grad_w"] += 1
        return sign, stats
    scratch, hq, wq, n_pad, x_pad = _wgrad_scratch(xq, B, Hp, Wp, C, dout, k,
                                                   stride)
    _call(_lib().conv_grad_w_sign, pred.data_ptr(), xq.data_ptr(),
          gq.data_ptr(), tau.data_ptr(), scratch.data_ptr(), sign.data_ptr(),
          stats.data_ptr(), B, Hp, Wp, C, ho, wo, dout, k, stride, hq, wq,
          n_pad, x_pad, bn_, nj, _stream(xq))
    LAUNCHES["conv_grad_w"] += 1
    return sign, stats
