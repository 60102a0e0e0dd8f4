"""Fake-quantization onto a symmetric fixed-point grid: one kernel.

One CUDA kernel (``csrc/quant.cu``) behind a wrapper with a plain PyTorch
version beside it.  A wrapper given a CPU tensor computes the plain version;
given a CUDA tensor it launches the kernel or raises.  Each launch adds one
to ``LAUNCHES["quantize"]``.

=========  ===================================================
wrapper    replaces (JAX package, ``kernels/quant.py``)
=========  ===================================================
quantize   ``quantize_pallas`` / ``_quant_kernel``
=========  ===================================================

``quantize(x, bits)`` computes the per-tensor scale with
``core/quant.qscale`` (a 0-d fp32 tensor that stays on the device: the
kernel reads it through its pointer, so no call reads it back to the host)
and then ``clip(round(x / s), -lim, lim) * s`` in one read and one write of
``x``, in ``x``'s dtype (fp32 or bf16).  The kernel divides with a correctly
rounded fp32 quotient and rounds half to even, as ``torch.round`` does, so
it equals the plain version bit for bit; the JAX package's jit may fuse
``q * s`` otherwise and land one ulp away (``tests/test_kernels.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.core.quant import qscale, round_codes
from repro_torch.kernels.conv import _call, _on_cuda, _stream

DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"quantize": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("quant")
    for fn in (lib.quantize_f32, lib.quantize_bf16):
        fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def quantize_plain(x: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded onto the ``bits``-bit grid of scale ``s`` (0-d fp32),
    in ``x.dtype``: ``core/quant``'s operations with the scale given."""
    return (round_codes(x, s, bits) * s).to(x.dtype)


def quantize_scaled(x: torch.Tensor, s: torch.Tensor, bits: int
                    ) -> torch.Tensor:
    """The elementwise pass alone: :func:`quantize_plain` on a CPU tensor,
    the kernel on a CUDA tensor (``s`` on the same device)."""
    if x.dtype not in DTYPES:
        raise ValueError(f"quantize takes fp32 or bf16, got {x.dtype}")
    if not _on_cuda(x, s):
        return quantize_plain(x, s, bits)
    if s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError(f"scale: expected one fp32 value, got {s.dtype} "
                         f"{tuple(s.shape)}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    aligned = int(xc.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _lib()
    fn = lib.quantize_f32 if x.dtype == torch.float32 else lib.quantize_bf16
    _call(fn, xc.data_ptr(), s.data_ptr(), out.data_ptr(), xc.numel(),
          aligned, 2.0 ** (bits - 1) - 1.0, _stream(xc))
    LAUNCHES["quantize"] += 1
    return out


def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quantize ``x`` (any shape, fp32 or bf16) on its own per-tensor
    ``bits``-bit grid."""
    return quantize_scaled(x, qscale(x, bits), bits)
