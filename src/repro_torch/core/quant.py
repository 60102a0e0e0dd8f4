"""Symmetric fixed-point quantization grids shared by PSG and the kernels.

The grids must equal the JAX package's bit for bit: the scale is
``max(max|x|, 1e-12) / (2^(b-1) - 1)`` in fp32, and codes are
``round(x / s)`` in fp32 with round-half-to-even (``torch.round``, like
``jnp.round``).  The division is a correctly rounded fp32 quotient wherever
it runs: here by a 0-d tensor, in the kernels by ``__fdiv_rn``
(``kernels/quant.py`` is :func:`quantize` as two kernels, the scale's
reduction and the elementwise pass).
"""
from __future__ import annotations

from typing import Tuple

import torch


def _lim(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1.0


def qscale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor scale ``max|x| / (2^(b-1) - 1)`` as an fp32 0-d tensor."""
    amax = x.float().abs().amax()
    # divide by a tensor: PyTorch multiplies a CUDA tensor divided by a
    # Python number by the number's reciprocal, which is not the fp32 quotient
    lim = torch.full((), _lim(bits), device=amax.device)
    return torch.clamp_min(amax, 1e-12) / lim


def round_codes(x: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
    """Codes of ``x`` on the ``bits``-bit grid of scale ``s`` (a 0-d fp32
    tensor), as fp32: ``clip(round(x / s), -lim, lim)``."""
    lim = _lim(bits)
    return torch.clamp(torch.round(x.float() / s), -lim, lim)


def _round_codes(x: torch.Tensor, bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    s = qscale(x, bits)
    return round_codes(x, s, bits), s


def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quantize: round onto the ``bits``-bit symmetric grid."""
    q, s = _round_codes(x, bits)
    return (q * s).to(x.dtype)


def quantize_int(x: torch.Tensor, bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer codes (int8 / int16 / int32 by width) and the grid scale."""
    q, s = _round_codes(x, bits)
    dt = torch.int8 if bits <= 8 else torch.int32 if bits > 16 else torch.int16
    return q.to(dt), s


def codes(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel operand codes: int8 for <= 8 bits, int16 otherwise (the JAX
    package's ``kernels/ops._codes``)."""
    q, s = _round_codes(x, bits)
    return q.to(torch.int8 if bits <= 8 else torch.int16), s
