"""JAX's counter-based random streams, bit for bit, in numpy.

SMD drops, SLU keep decisions and synthetic batches are keyed exactly as in
the JAX package (``fold_in(PRNGKey(seed), step)`` and so on), so the port
draws the same numbers at every step.  This module is a numpy copy of
``jax.random`` on its default implementation as of jax 0.9.0: threefry2x32
with ``jax_threefry_partitionable=True``, where ``split`` and ``fold_in``
hash the key with a counter and ``random_bits`` hashes the flat element
index.  It imports no JAX.

A key is a ``(2,)`` ``uint32`` array.  ``uniform``, ``bernoulli`` and
``randint`` reproduce JAX's bits exactly.  ``normal`` is
``sqrt(2) * erfinv(u)`` with XLA's float32 ``erfinv`` polynomial; its
``log1p`` is numpy's, so a value can differ from JAX's in the last few ulp.
Draws happen on the host: callers move the result to their device.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

Key = np.ndarray
Shape = Union[int, Sequence[int]]

_U32 = np.uint32
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``,
    1-d ``uint32`` arrays, under ``key``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + _U32(ks[0])
    x1 = x1 + _U32(ks[1])
    tmp = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, _U32(r), out=tmp)
            x1 >>= _U32(32 - r)
            x1 |= tmp
            x1 ^= x0
        x0 += _U32(ks[(i + 1) % 3])
        x1 += _U32((ks[(i + 2) % 3] + i + 1) & _MASK)
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` for an int32 seed (64-bit mode off)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit int32")
    return np.array([0, seed & _MASK], dtype=_U32)


def _hash_counters(key: Key, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry of the 64-bit counters ``0 .. n-1`` split as (hi, lo)."""
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(_MASK)).astype(_U32)
    return threefry2x32(key, hi, lo)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the key hashed with the counter ``(0, data)``."""
    x0, x1 = threefry2x32(key, np.zeros(1, _U32),
                          np.array([int(data) & _MASK], _U32))
    return np.array([x0[0], x1[0]], dtype=_U32)


def split(key: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``(num, 2)`` keys; row ``i`` equals
    ``fold_in(key, i)``."""
    x0, x1 = _hash_counters(key, num)
    return np.stack([x0, x1], axis=1)


def random_bits(key: Key, shape: Shape = ()) -> np.ndarray:
    """32 random bits per element (``jax.random.bits``)."""
    shape = _shape(shape)
    x0, x1 = _hash_counters(key, math.prod(shape))
    x0 ^= x1
    return x0.reshape(shape)


def uniform(key: Key, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 ``U[minval, maxval)``: the top 23 bits as a mantissa of
    ``[1, 2)``, shifted, then ``u * (maxval - minval) + minval`` rounded
    once, as XLA fuses it into a multiply-add (float64 holds the product
    and the sum exactly at these magnitudes)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    bits >>= _U32(9)
    bits |= np.float32(1.0).view(_U32)
    floats = bits.view(np.float32) - np.float32(1.0)
    if lo == 0.0 and hi == 1.0:
        return floats
    fma = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fma.astype(np.float32))


def bernoulli(key: Key, p: float, shape: Shape = ()) -> np.ndarray:
    """``uniform < p`` in float32."""
    return uniform(key, shape) < np.float32(p)


def randint(key: Key, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """int32 draws in ``[minval, maxval)`` by JAX's algorithm: two 32-bit
    draws combined modulo the span, with every product wrapped to 32 bits
    as ``uint32`` arithmetic does."""
    i32 = np.iinfo(np.int32)
    out_of_range = maxval > i32.max
    minval = int(np.clip(minval, i32.min, i32.max))
    maxval = int(np.clip(maxval, i32.min, i32.max))
    k1, k2 = split(key)
    higher = random_bits(k1, shape).astype(np.uint64)
    lower = random_bits(k2, shape).astype(np.uint64)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    if out_of_range and maxval > minval:
        span = (span + 1) & _MASK
    if span == 0:          # 2**32: the remainders leave the bits unchanged
        offset = (higher * np.uint64(2 ** 32) + lower) & np.uint64(_MASK)
    else:
        m = (2 ** 16) % span
        m = ((m * m) & _MASK) % span
        s = np.uint64(span)
        offset = ((higher % s) * np.uint64(m)) & np.uint64(_MASK)
        offset = ((offset + lower % s) & np.uint64(_MASK)) % s
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


# XLA's float32 erfinv (stablehlo's chlo decomposition; M. Giles,
# "Approximating the erfinv function"), coefficients highest power first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    out = np.empty_like(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(x * -x)
        small = w < np.float32(5.0)
        for sel, coeffs in ((small, _ERFINV_SMALL), (~small, _ERFINV_LARGE)):
            ws = w[sel]
            ws = ws - np.float32(2.5) if coeffs is _ERFINV_SMALL \
                else np.sqrt(ws) - np.float32(3.0)
            w64 = ws.astype(np.float64)
            p = np.full(ws.shape, np.float32(coeffs[0]), np.float32)
            p64 = np.empty_like(w64)
            for c in coeffs[1:]:
                # each Horner step rounded once, as XLA's fused multiply-add
                np.multiply(p, w64, out=p64)
                p64 += np.float64(np.float32(c))
                p[...] = p64
            out[sel] = p * x[sel]
        edge = np.abs(x) == np.float32(1.0)
        out[edge] = x[edge] * np.float32(np.inf)
    return out


def normal(key: Key, shape: Shape = ()) -> np.ndarray:
    """float32 standard normals: ``sqrt(2) * erfinv(u)``, ``u`` uniform on
    ``[nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2.0)) * erfinv_f32(u)
