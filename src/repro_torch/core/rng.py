"""Counter-based randomness: every draw is a pure function of a key tuple.

SMD drops, SLU keep decisions and synthetic batches are keyed on integers
such as ``(seed, step)`` or ``(seed, step, shard)``, as in the JAX package,
so any host can recompute any decision.  The keys are mixed with
SplitMix64 into the seed of a fresh ``torch.Generator``.  The streams are
PyTorch's, not JAX's threefry: decisions match the JAX package in
distribution, not draw by draw.
"""
from __future__ import annotations

import torch

_MASK = (1 << 64) - 1

# stream tags: the first element of every key, so that no two uses of one
# (seed, step) share a stream
SMD, SLU, DATA = 1, 2, 3


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def key_seed(*key: int) -> int:
    """A 63-bit generator seed from a tuple of integers."""
    h = 0
    for k in key:
        h = _splitmix64(h ^ (int(k) & _MASK))
    return h >> 1


def generator(*key: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key_seed(*key))


def uniform(*key: int) -> float:
    """One U[0, 1) draw on the host."""
    return float(torch.rand((), generator=generator(*key)))
