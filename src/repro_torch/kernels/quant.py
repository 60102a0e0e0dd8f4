"""Fake-quantization onto a symmetric fixed-point grid: one kernel.

Two CUDA kernels (``csrc/quant.cu``), the scale's reduction and the
elementwise pass, behind one wrapper with a plain PyTorch version beside
it.  A wrapper given a CPU tensor computes the plain version; given a CUDA
tensor it launches the kernels or raises.  Each call of a wrapper that
launches adds one to ``LAUNCHES["quantize"]``.

=========  ===================================================
wrapper    replaces (JAX package, ``kernels/quant.py``)
=========  ===================================================
quantize   ``quantize_pallas`` / ``_quant_kernel``, and its amax
=========  ===================================================

``quantize(x, bits)`` runs two launches and no PyTorch op on the card: the
reduction writes each block's ``max|x|`` to its own slot of a scratch
vector, and the pass reduces the slots again, forms the per-tensor scale
``max(max|x|, 1e-12) / lim`` (``core/quant.qscale``'s operations, so the
scale equals it bit for bit, a NaN in ``x`` giving a NaN scale and an
all-zero ``x`` the 1e-12 floor; :func:`scale_plain` is that arithmetic in
PyTorch) and computes ``clip(round(x / s), -lim, lim) * s`` in one read and
one write of ``x``, in ``x``'s dtype (fp32 or bf16).  The pass divides with
a correctly rounded fp32 quotient and rounds half to even, as
``torch.round`` does, so it equals the plain version bit for bit; the JAX
package's jit may fuse ``q * s`` otherwise and land one ulp away
(``tests/test_kernels.py``).  :func:`quantize_scaled` is the pass alone on a
scale given on the device, :func:`absmax` the reduction alone.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.quant import round_codes
from repro_torch.kernels.conv import _call, _on_cuda, _stream

DTYPES = (torch.float32, torch.bfloat16)
SCALE_FLOOR = 1e-12      # the scale's floor, as core/quant.qscale clamps it

LAUNCHES: Dict[str, int] = {"quantize": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("quant")
    for fn in (lib.quantize_f32, lib.quantize_bf16):
        fn.argtypes = [_P, _P, _P, _P, _LL, _I, ctypes.c_float, _P]
    for fn in (lib.quantize_scaled_f32, lib.quantize_scaled_bf16):
        fn.argtypes = [_P, _P, _P, _LL, _I, ctypes.c_float, _P]
    for fn in (lib.absmax_f32, lib.absmax_bf16):
        fn.argtypes = [_P, _P, _LL, _I, ctypes.POINTER(_I), _P]
    lib.quantize_partials.argtypes = []
    for fn in (lib.quantize_f32, lib.quantize_bf16, lib.quantize_scaled_f32,
               lib.quantize_scaled_bf16, lib.absmax_f32, lib.absmax_bf16,
               lib.quantize_partials):
        fn.restype = _I
    return lib


def _lim(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1.0


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """``max|x|`` as the reduction kernel takes it, a 0-d fp32 tensor: the
    largest float bits with the sign bit cleared (a NaN's lie above inf's,
    so a NaN wins; ``-0.0`` counts as 0)."""
    bits = x.float().reshape(-1).view(torch.int32) & 0x7FFFFFFF
    return bits.amax().view(torch.float32)


def scale_plain(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernel's scale in PyTorch: ``absmax_plain(x)`` raised to the
    1e-12 floor by a test that a NaN fails (so it passes, as
    ``torch.clamp_min`` lets it), divided by ``lim`` as a tensor (the
    correctly rounded quotient).  Equal to ``core/quant.qscale`` bit for
    bit (``tests/test_torch_tensor_core_math.py``)."""
    amax = absmax_plain(x)
    floor = torch.full((), SCALE_FLOOR, device=amax.device)
    return torch.where(amax < floor, floor, amax) / torch.full(
        (), _lim(bits), device=amax.device)


def quantize_plain(x: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded onto the ``bits``-bit grid of scale ``s`` (0-d fp32),
    in ``x.dtype``: ``core/quant``'s operations with the scale given."""
    return (round_codes(x, s, bits) * s).to(x.dtype)


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"quantize takes fp32 or bf16, got {x.dtype}")


def _operand(x: torch.Tensor) -> Tuple[torch.Tensor, int, ctypes.CDLL]:
    """``x`` contiguous, whether it is 16-byte aligned, and the library."""
    xc = x.contiguous()
    return xc, int(xc.data_ptr() % 16 == 0), _lib()


def quantize_scaled(x: torch.Tensor, s: torch.Tensor, bits: int
                    ) -> torch.Tensor:
    """The elementwise pass alone: :func:`quantize_plain` on a CPU tensor,
    the pass kernel on a CUDA tensor (``s`` on the same device)."""
    _check_dtype(x)
    if not _on_cuda(x, s):
        return quantize_plain(x, s, bits)
    if s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError(f"scale: expected one fp32 value, got {s.dtype} "
                         f"{tuple(s.shape)}")
    xc, aligned, lib = _operand(x)
    out = torch.empty_like(xc)
    fn = lib.quantize_scaled_f32 if x.dtype == torch.float32 \
        else lib.quantize_scaled_bf16
    _call(fn, xc.data_ptr(), s.data_ptr(), out.data_ptr(), xc.numel(),
          aligned, _lim(bits), _stream(xc))
    LAUNCHES["quantize"] += 1
    return out


def absmax(x: torch.Tensor) -> torch.Tensor:
    """The reduction alone: on a CUDA tensor the kernel's block maxima of
    ``|x|`` (fp32, one per block; their max is ``max|x|``), on a CPU tensor
    :func:`absmax_plain` as one of them."""
    _check_dtype(x)
    if not _on_cuda(x):
        return absmax_plain(x).reshape(1)
    xc, aligned, lib = _operand(x)
    partial = torch.empty(lib.quantize_partials(), device=x.device,
                          dtype=torch.int32)
    nparts = _I(0)
    fn = lib.absmax_f32 if x.dtype == torch.float32 else lib.absmax_bf16
    _call(fn, xc.data_ptr(), partial.data_ptr(), xc.numel(), aligned,
          ctypes.byref(nparts), _stream(xc))
    return partial[:nparts.value].view(torch.float32)


def _quantize(x: torch.Tensor, bits: int, want_scale: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_dtype(x)
    if not _on_cuda(x):
        s = scale_plain(x, bits)
        return quantize_plain(x, s, bits), s
    xc, aligned, lib = _operand(x)
    out = torch.empty_like(xc)
    partial = torch.empty(lib.quantize_partials(), device=x.device,
                          dtype=torch.int32)
    s = torch.empty((), device=x.device) if want_scale else None
    fn = lib.quantize_f32 if x.dtype == torch.float32 else lib.quantize_bf16
    _call(fn, xc.data_ptr(), partial.data_ptr(),
          s.data_ptr() if want_scale else None, out.data_ptr(), xc.numel(),
          aligned, _lim(bits), _stream(xc))
    LAUNCHES["quantize"] += 1
    return out, s


def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quantize ``x`` (any shape, fp32 or bf16) on its own per-tensor
    ``bits``-bit grid."""
    return _quantize(x, bits, False)[0]


def quantize_with_scale(x: torch.Tensor, bits: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize` and the scale it used (0-d fp32)."""
    return _quantize(x, bits, True)
