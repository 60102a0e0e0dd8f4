"""Kernel backend dispatch: the one place that picks how a PSG op runs.

The counterpart of the JAX package's ``kernels/dispatch.py``.  Every
dispatched op runs on one of three backends:

* ``"reference"``: the element-level oracles of ``kernels/ref.py`` (the
  fallback ratio is the fraction of *entries* below the threshold);
* ``"plain"``: the tile-level plain PyTorch versions beside the kernels
  (the JAX package's ``"interpret"``), on the tensors' device;
* ``"cuda"``: the kernels (the JAX package's ``"mosaic"``); CPU tensors
  raise.

Selection, strongest first:

1. an active :func:`override_backend` context (tests, benchmarks);
2. ``PSGConfig.backend`` when it is not ``"auto"``;
3. the process default: ``REPRO_TORCH_KERNEL_BACKEND``, read once when this
   module is imported (a name of the port's own, so a pin of the JAX
   package's ``REPRO_KERNEL_BACKEND`` does not reach it), or
   :func:`set_default_backend`;
4. ``"auto"``: the wrappers decide by the tensors' device, CUDA tensors
   launch the kernels and CPU tensors take the plain versions.  ``auto``
   never runs a plain version or an oracle on the card; only an explicit
   pin does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Optional, Tuple

import torch

from repro_torch.core.config import KERNEL_BACKENDS, PSGConfig, validate_backend
from repro_torch.kernels import ops, ref

BACKEND_AUTO = "auto"
BACKEND_REFERENCE = "reference"
BACKEND_PLAIN = "plain"
BACKEND_CUDA = "cuda"
BACKENDS = KERNEL_BACKENDS[1:]   # the pins; under "auto" the wrappers pick

_ENV_DEFAULT = os.environ.get("REPRO_TORCH_KERNEL_BACKEND", "").strip().lower()

_state = threading.local()
_process_default: Optional[str] = None


_validate = validate_backend    # "auto" or one of BACKENDS, else ValueError


def default_backend() -> str:
    """The process-wide default: the import-time env pin, else ``auto``."""
    global _process_default
    if _process_default is None:
        _process_default = _validate(_ENV_DEFAULT or BACKEND_AUTO)
    return _process_default


def set_default_backend(name: Optional[str]) -> None:
    """Pin the process-wide default; ``None`` returns to the env pin read
    at import (or ``auto``)."""
    global _process_default
    _process_default = _validate(name) if name is not None else None


@contextlib.contextmanager
def override_backend(name: str):
    """Run the ops called in this context, on this thread, on ``name``."""
    _validate(name)
    prev = getattr(_state, "override", None)
    _state.override = name
    try:
        yield
    finally:
        _state.override = prev


def resolve_backend(cfg: Optional[PSGConfig] = None) -> str:
    """The backend an op called now with ``cfg`` uses; under ``"auto"`` the
    wrappers decide by the tensors' device."""
    override = getattr(_state, "override", None)
    if override is not None:
        return override
    if cfg is not None and cfg.backend != BACKEND_AUTO:
        return cfg.backend
    return default_backend()


def pinned(cfg: PSGConfig) -> PSGConfig:
    """``cfg`` with the backend resolved now, so that an autograd backward
    that runs after an :func:`override_backend` context has closed still
    uses the backend its forward ran under."""
    backend = resolve_backend(cfg)
    if backend == cfg.backend:
        return cfg
    return dataclasses.replace(cfg, backend=backend)


def backend_for(cfg: Optional[PSGConfig], *tensors: torch.Tensor) -> str:
    """The backend for an op on ``tensors``.  ``auto`` stays ``auto``: the
    ops then call the wrappers, which launch their kernels on CUDA tensors
    and compute the plain versions on CPU tensors.  ``cuda`` on CPU tensors
    raises."""
    backend = resolve_backend(cfg)
    if backend == BACKEND_CUDA and not all(t.is_cuda for t in tensors):
        raise ValueError("kernel backend 'cuda' needs CUDA tensors; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return backend


# ---------------------------------------------------------------------------
# dispatched ops: the PSG autograd functions call these
# ---------------------------------------------------------------------------


def quantize(x: torch.Tensor, bits: int,
             cfg: Optional[PSGConfig] = None) -> torch.Tensor:
    """Fake-quantize ``x`` on its per-tensor ``bits``-bit grid: kernel 10,
    its plain version, or the oracle."""
    backend = backend_for(cfg, x)
    if backend == BACKEND_REFERENCE:
        return ref.quantize_ref(x, bits)
    return ops.quantize(x, bits, plain=backend == BACKEND_PLAIN)


def psg_grad_w(x2: torch.Tensor, gy2: torch.Tensor, cfg: PSGConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG weight-gradient sign of ``x2 (N, din) @ w`` and the measured
    fallback ratio: of 128 x 128 tiles on ``plain``/``cuda``, of entries on
    ``reference``."""
    backend = backend_for(cfg, x2, gy2)
    xf, gf = x2.float(), gy2.float()
    if backend == BACKEND_REFERENCE:
        return (ref.psg_grad_w_ref(xf, gf, cfg),
                ref.psg_fallback_ratio_ref(xf, gf, cfg))
    return ops.psg_grad_w(xf, gf, cfg, plain=backend == BACKEND_PLAIN)


def conv_fwd(xq: torch.Tensor, wq: torch.Tensor, cfg: Optional[PSGConfig],
             *, k: int, stride: int) -> torch.Tensor:
    """Conv forward on pre-quantized operands (pre-padded NHWC input,
    patch-major weight): the implicit-GEMM kernel, its tap loop, or im2col
    + one GEMM on ``reference``."""
    backend = backend_for(cfg, xq, wq)
    if backend == BACKEND_REFERENCE:
        return ref.conv_fwd_ref(xq, wq, k, stride)
    return ops.conv_fwd(xq, wq, k, stride, plain=backend == BACKEND_PLAIN)


def conv_grad_x(gq: torch.Tensor, wq: torch.Tensor, cfg: Optional[PSGConfig],
                *, k: int, stride: int, hp: int, wp: int) -> torch.Tensor:
    """Conv input gradient on pre-quantized operands, ``(B, hp, wp, C)``
    fp32."""
    backend = backend_for(cfg, gq, wq)
    if backend == BACKEND_REFERENCE:
        return ref.conv_grad_x_ref(gq, wq, k, stride, hp, wp)
    return ops.conv_grad_x(gq, wq, k, stride, hp, wp,
                           plain=backend == BACKEND_PLAIN)


def conv_grad_w(xp: torch.Tensor, gy: torch.Tensor, cfg: PSGConfig, *,
                k: int, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSG conv weight-gradient sign and the measured fallback ratio: of
    (tap, 128-wide dout block) tiles on ``plain``/``cuda``, of entries of
    the im2col product on ``reference``."""
    backend = backend_for(cfg, xp, gy)
    xf, gf = xp.float(), gy.float()
    if backend == BACKEND_REFERENCE:
        return (ref.conv_grad_w_ref(xf, gf, cfg, k, stride),
                ref.conv_fallback_ratio_ref(xf, gf, cfg, k, stride))
    return ops.conv_grad_w(xf, gf, cfg, k, stride,
                           plain=backend == BACKEND_PLAIN)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: Optional[PSGConfig], *, causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward and its logsumexp, ``(o in q.dtype, lse (B, nh, S)
    fp32)``: the flash kernel, its plain version, or the materialized
    softmax on ``reference``."""
    backend = backend_for(cfg, q, k, v)
    if backend == BACKEND_REFERENCE:
        o = ref.flash_attention_oracle(q, k, v, causal).to(q.dtype)
        return o, ref.attention_lse_ref(q, k, causal)
    return ops.flash_attention_fwd(q, k, v, causal=causal,
                                   plain=backend == BACKEND_PLAIN)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  cfg: PSGConfig, *, causal: bool = True):
    """PSG attention backward, ``(dq, dk, dv, fallback ratio)``.  The
    ratio is of 128-row kv tiles in every backend; ``reference`` selects on
    products of the materialized probabilities and recomputes them from q,
    k and v (``o`` and ``lse`` unused)."""
    backend = backend_for(cfg, q, k, v, do)
    if backend == BACKEND_REFERENCE:
        return ref.psg_attention_bwd_ref(q, k, v, do, cfg, causal)
    return ops.flash_attention_bwd(q, k, v, o, lse, do, cfg, causal=causal,
                                   plain=backend == BACKEND_PLAIN)
