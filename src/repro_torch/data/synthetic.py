"""Deterministic synthetic data (no dataset download), the JAX package's
batches exactly.

* ``GaussianImageTask``: class-conditional Gaussian images, 32x32x3, K
  classes.  The class means come from numpy's ``RandomState``; labels and
  noise from the threefry stream keyed on ``(seed, step, shard)``.
* ``MarkovLMTask``: tokens of a fixed random first-order Markov chain (the
  designated successor with probability ``peak``, a uniform token
  otherwise), so the Bayes-optimal cross-entropy is known.

Every batch is a pure function of ``(seed, step, shard)`` drawn with
``core/rng.py``, which reproduces ``jax.random``: labels and tokens equal
the JAX package's, and image noise equals it within a few ulp
(``rng.normal``).  Batches are drawn on the host and moved to ``device``;
a dropped step draws nothing.  ``host_image_batch`` and ``host_lm_batch``
make the same batches as CPU tensors, pinned on request, for the prefetch
thread of the chunked loop (``data/pipeline.py``), which must not issue a
copy to the card.

A model with a frontend (whisper's audio frames, phi-3-vision's patches,
stubs in both packages) takes ``"frontend"`` embeddings beside its tokens:
:func:`host_frontend`, the JAX launcher's
``jax.random.normal(fold_in(PRNGKey(7), step), (B, F, d), act dtype)``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import rng


def _batch_key(seed: int, step: int, shard: int) -> rng.Key:
    return rng.fold_in(rng.fold_in(rng.PRNGKey(seed), step), shard)


@dataclass(frozen=True)
class GaussianImageTask:
    num_classes: int = 10
    hw: int = 32
    snr: float = 1.0
    seed: int = 99

    def means(self) -> np.ndarray:
        r = np.random.RandomState(self.seed)
        return r.randn(self.num_classes, self.hw, self.hw, 3).astype(np.float32)


def _host(arrays: Dict[str, np.ndarray], pin: bool
          ) -> Dict[str, torch.Tensor]:
    out = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def _image_arrays(task: GaussianImageTask, seed: int, step: int, shard: int,
                  batch: int) -> Dict[str, np.ndarray]:
    k0, k1 = rng.split(_batch_key(seed, step, shard))
    labels = rng.randint(k0, (batch,), 0, task.num_classes)
    noise = rng.normal(k1, (batch, task.hw, task.hw, 3))
    images = np.float32(task.snr) * task.means()[labels] + noise
    return {"image": images, "label": labels.astype(np.int64)}


def host_image_batch(task: GaussianImageTask, seed: int, step: int,
                     shard: int, batch: int, pin: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """:func:`make_image_batch` as CPU tensors (pinned with ``pin``)."""
    return _host(_image_arrays(task, seed, step, shard, batch), pin)


def make_image_batch(task: GaussianImageTask, seed: int, step: int, shard: int,
                     batch: int, device) -> Dict[str, torch.Tensor]:
    """``{"image": (batch, hw, hw, 3) fp32, "label": (batch,) int64}``."""
    return {k: v.to(device) for k, v in
            host_image_batch(task, seed, step, shard, batch).items()}


@dataclass(frozen=True)
class MarkovLMTask:
    vocab: int = 256
    peak: float = 0.9           # probability of the designated next token
    seed: int = 1234

    def transition(self) -> np.ndarray:
        """The designated successor of each token (read-only, computed once
        per task)."""
        return _transition(self.vocab, self.seed)

    def bayes_xent(self) -> float:
        p, v = self.peak, self.vocab
        q = (1 - p) / (v - 1)
        return float(-(p * np.log(p) + (v - 1) * q * np.log(q)))


@functools.lru_cache(maxsize=None)
def _transition(vocab: int, seed: int) -> np.ndarray:
    perm = np.random.RandomState(seed).permutation(vocab)
    perm.flags.writeable = False
    return perm


def make_lm_batch(task: MarkovLMTask, seed: int, step: int, shard: int,
                  batch: int, seq: int, device) -> Dict[str, torch.Tensor]:
    """``{"tokens": (batch, seq), "labels": (batch, seq)}`` int64: ``seq``
    chain steps after a random start token; tokens are steps ``0 .. seq-2``
    padded with 0, labels steps ``1 .. seq-1`` padded with -1 (ignored by
    the loss)."""
    return {k: v.to(device) for k, v in
            host_lm_batch(task, seed, step, shard, batch, seq).items()}


def host_lm_batch(task: MarkovLMTask, seed: int, step: int, shard: int,
                  batch: int, seq: int, pin: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """:func:`make_lm_batch` as CPU tensors (pinned with ``pin``)."""
    if seq < 2:
        raise ValueError(f"an LM batch needs seq >= 2, got {seq}")
    k0, k1, k2 = rng.split(_batch_key(seed, step, shard), 3)
    t = rng.randint(k0, (batch,), 0, task.vocab)
    noise = rng.uniform(k1, (batch, seq)) > np.float32(task.peak)
    rand_next = rng.randint(k2, (batch, seq), 0, task.vocab)
    perm = task.transition()
    toks = np.empty((batch, seq), np.int64)
    for i in range(seq):            # the chain is sequential in time only
        t = np.where(noise[:, i], rand_next[:, i], perm[t])
        toks[:, i] = t
    tokens = np.zeros((batch, seq), np.int64)
    labels = np.full((batch, seq), -1, np.int64)
    tokens[:, :-1], labels[:, :-1] = toks[:, :-1], toks[:, 1:]
    return _host({"tokens": tokens, "labels": labels}, pin)


FRONTEND_SEED = 7               # the JAX launcher's PRNGKey of the frontend


def host_frontend(cfg, step: int, batch: int, seed: int = FRONTEND_SEED,
                  pin: bool = False) -> torch.Tensor:
    """Frontend embeddings ``(batch, frontend_tokens, d_model)`` in the
    activation dtype, as a CPU tensor (pinned with ``pin``): standard
    normals of ``fold_in(PRNGKey(seed), step)`` drawn in that dtype
    (``rng.normal``; bf16 draws are JAX's bit for bit)."""
    shape = (batch, cfg.frontend_tokens, cfg.d_model)
    x = rng.normal(rng.fold_in(rng.PRNGKey(seed), step), shape, cfg.dtype)
    t = torch.from_numpy(x).to(getattr(torch, cfg.dtype))
    return t.pin_memory() if pin else t


def with_frontend(b: Dict[str, torch.Tensor], cfg, step: int,
                  seed: int = FRONTEND_SEED, pin: bool = False,
                  device: Optional[torch.device] = None
                  ) -> Dict[str, torch.Tensor]:
    """``b`` with ``"frontend"`` (:func:`host_frontend` of its rows) when
    ``cfg`` has a frontend, on ``device`` if given; else ``b``."""
    if not cfg.frontend:
        return b
    f = host_frontend(cfg, step, b["tokens"].shape[0], seed, pin)
    return {**b, "frontend": f if device is None else f.to(device)}
