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
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cost
from repro_torch.core.config import KERNEL_BACKENDS, PSGConfig, validate_backend
from repro_torch.distributed import sharding
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
    raises; so does any op under the static audit's op counter."""
    cost.refuse_if_counting()
    backend = resolve_backend(cfg)
    if backend == BACKEND_REFERENCE and sharding.data_group() is not None:
        raise NotImplementedError("the reference backend's oracles take "
                                  "each rank's rows alone: they run outside "
                                  "a mesh only")
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


def conv_fwd(xc: torch.Tensor, sx: torch.Tensor, wc: torch.Tensor,
             sw: torch.Tensor, cfg: Optional[PSGConfig], *, k: int,
             stride: int) -> torch.Tensor:
    """Conv forward on quantized operands given as codes and fp32 0-d
    scales (pre-padded NHWC input, patch-major weight): the implicit-GEMM
    kernel, its tap loop, or im2col + one GEMM on ``reference``, each on
    ``xc * sx`` and ``wc * sw``."""
    backend = backend_for(cfg, xc, wc)
    if backend == BACKEND_REFERENCE:
        return ref.conv_fwd_ref(xc.float() * sx, wc.float() * sw, k, stride)
    return ops.conv_fwd(xc, sx, wc, sw, k, stride,
                        plain=backend == BACKEND_PLAIN)


def conv_grad_x(gc: torch.Tensor, sg: torch.Tensor, wc: torch.Tensor,
                sw: torch.Tensor, cfg: Optional[PSGConfig], *, k: int,
                stride: int, hp: int, wp: int) -> torch.Tensor:
    """Conv input gradient on quantized operands given as codes and fp32
    0-d scales, ``(B, hp, wp, C)`` fp32: the implicit-GEMM kernel, its tap
    loop, or the col2im oracle on ``reference``, each on ``gc * sg`` and
    ``wc * sw``."""
    backend = backend_for(cfg, gc, wc)
    if backend == BACKEND_REFERENCE:
        return ref.conv_grad_x_ref(gc, sg, wc, sw, k, stride, hp, wp)
    return ops.conv_grad_x(gc, sg, wc, sw, k, stride, hp, wp,
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


# ---------------------------------------------------------------------------
# shipped-kernel registry: the linters' worklist
# ---------------------------------------------------------------------------


def conv_lint_geometries() -> Dict[str, Tuple[int, int, int, int, int]]:
    """Kernel-facing conv geometries the linters cover, one per conv *kind*
    that ships: ``kind -> (k, stride, hw, cin, cout)``, the JAX package's.

    From ``configs/paper_cnns.resnet_conv_shapes`` (ResNet-14's deepest
    stage of each kind, ``psg.conv2d``'s ``k < stride`` pre-subsample
    applied: the kernels never see ``k < stride``), plus the
    MobileNetV2-style ``point`` 1x1 with a ``dout`` that is no multiple of
    128, so the padded dout block is linted too.  ``cout`` is widened to
    256 so the dout axis tiles: a coverage bug cannot hide behind a
    degenerate grid.
    """
    from repro_torch.configs.paper_cnns import resnet_conv_shapes

    by_kind = {}
    for c in resnet_conv_shapes(depth=14, width=16, batch=4):
        by_kind[c.kind] = c                 # last occurrence: deepest stage
    geoms: Dict[str, Tuple[int, int, int, int, int]] = {}
    for kind, c in sorted(by_kind.items()):
        k, s, hw = c.k, c.stride, c.hw
        if k < s:                           # 1x1 downsample: pre-subsampled
            hw, s = -(-hw // s), 1
        geoms[kind] = (k, s, hw, c.cin, 256)
    geoms["point"] = (1, 1, 4, 40, 200)     # padded dout block (n_j = 2)
    return geoms


LINT_BATCH = 4          # images of the conv lint geometries
LINT_SEED = 0


def _ints(gen: np.random.Generator, shape, lim: int, dtype, device
          ) -> torch.Tensor:
    return torch.from_numpy(
        gen.integers(-lim, lim + 1, size=shape)).to(dtype).to(device)


def _normal(gen: np.random.Generator, shape, device,
            dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _conv_entries(kind: str, geom, wide: bool = False
                  ) -> Dict[str, Tuple[Callable, Callable]]:
    """Kernels 1-4 at one conv geometry.  ``wide``: 16-bit codes for
    kernels 1-2 (their fp32 kernels, as int16 weight codes run them)."""
    from repro_torch.kernels import conv as K

    k, s, hw, cin, cout = geom
    B, pad = LINT_BATCH, k // 2
    hp = hw + 2 * pad
    ho = (hp - k) // s + 1
    tag = f"[{kind},int16]" if wide else f"[{kind}]"
    code = torch.int16 if wide else torch.int8

    def fwd_args(dev):
        g = np.random.default_rng([LINT_SEED, 1, hw, cin])
        return (_ints(g, (B, hp, hp, cin), 127, code, dev), _f32(0.02, dev),
                _ints(g, (k * k * cin, cout), 127, code, dev),
                _f32(0.01, dev))

    def dx_args(dev):
        g = np.random.default_rng([LINT_SEED, 2, hw, cin])
        return (_ints(g, (B, ho, ho, cout), 32767, torch.int16, dev),
                _f32(1e-4, dev),
                _ints(g, (k * k * cin, cout), 127, code, dev),
                _f32(0.01, dev))

    def codes(dev, tag_):
        g = np.random.default_rng([LINT_SEED, tag_, hw, cin])
        return (_ints(g, (B, hp, hp, cin), 7, torch.int8, dev),
                _ints(g, (B, ho, ho, cout), 511, torch.int16, dev),
                _ints(g, (B, hp, hp, cin), 127, torch.int8, dev),
                _ints(g, (B, ho, ho, cout), 32767, torch.int16, dev))

    def pred_args(dev):
        xm, gm, _, _ = codes(dev, 3)
        return xm, gm

    def sign_args(dev):
        xm, gm, xq, gq = codes("cpu", 3)
        pred = K.conv_grad_w_predictor_plain(xm, gm, k, s)
        tau = PSGConfig().beta * pred.abs().amax()
        return tuple(t.to(dev) for t in (pred, xq, gq, tau))

    entries = {
        f"conv_fwd{tag}": (
            lambda xc, sx, wc, sw: K.conv_fwd(xc, sx, wc, sw, k, s),
            fwd_args),
        f"conv_grad_x{tag}": (
            lambda gc, sg, wc, sw: K.conv_grad_x(gc, sg, wc, sw, k, s, hp,
                                                 hp), dx_args)}
    if not wide:
        entries[f"conv_grad_w_predictor{tag}"] = (
            lambda xm, gm: K.conv_grad_w_predictor(xm, gm, k, s), pred_args)
        entries[f"conv_grad_w{tag}"] = (
            lambda pred, xq, gq, tau: K.conv_grad_w(pred, xq, gq, tau, k, s),
            sign_args)
    return entries


def _flash_entries(dtype: torch.dtype) -> Dict[str, Tuple[Callable,
                                                          Callable]]:
    """Kernels 7-9 at S = 256 (two 128-row tiles), 4 heads over 2 kv heads,
    hd 128, causal, in ``dtype`` (lse, delta and the scales fp32)."""
    from repro_torch.kernels import flash_attn as FA

    cfg = PSGConfig()
    lims = (FA.qlim(cfg.bits_x), FA.qlim(cfg.bits_x_msb),
            FA.qlim(cfg.bits_g), FA.qlim(cfg.bits_g_msb))
    tag = "[bf16]" if dtype == torch.bfloat16 else ""

    def qkv(dev):
        g = np.random.default_rng([LINT_SEED, 7])
        return tuple(_normal(g, shape, dev, dtype)
                     for shape in ((2, 256, 4, 128), (2, 256, 2, 128),
                                   (2, 256, 2, 128), (2, 256, 4, 128)))

    def rows(dev):
        q, k, v, do = qkv("cpu")
        o, lse = FA.flash_attention_plain(q, k, v, causal=True)
        delta = torch.einsum("bsnh,bsnh->bns", do.float(), o.float())
        return (q, k, v, do, lse, delta.contiguous()), dev

    def dq_args(dev):
        t, _ = rows(dev)
        return tuple(x.to(dev) for x in t)

    def dkv_args(dev):
        (q, k, v, do, lse, delta), _ = rows(dev)
        scales = FA.attention_psg_scales(
            q, v, do, delta, bits_x=cfg.bits_x, bits_x_msb=cfg.bits_x_msb,
            bits_g=cfg.bits_g, bits_g_msb=cfg.bits_g_msb)
        return tuple(x.to(dev) for x in (q, k, v, do, lse, delta, scales))

    return {
        f"flash_fwd{tag}": (
            lambda q, k, v: FA.flash_fwd(q, k, v, causal=True),
            lambda dev: qkv(dev)[:3]),
        f"flash_bwd_dq{tag}": (
            lambda *a: FA.flash_bwd_dq(*a, causal=True), dq_args),
        f"flash_bwd_dkv{tag}": (
            lambda *a: FA.flash_bwd_dkv(*a, lims=lims, causal=True),
            dkv_args)}


def shipped_kernels() -> Dict[str, Tuple[Callable, Callable]]:
    """Every kernel the port ships, at its lint geometries:
    ``name -> (fn, make_args)``.  ``make_args(device)`` makes the operands
    from a seed; ``fn(*operands)`` is the kernel's wrapper, which launches
    the kernel on CUDA tensors and computes the plain version on CPU
    tensors.  The JAX package's registry at the port's wrappers: kernels
    1-4 once per :func:`conv_lint_geometries` kind (``name[kind]``; kernels
    1-2 also on 16-bit codes, their fp32 kernels), kernels 5-6 at N = 1024
    tokens, din = dout = 256, kernels 7-9 in fp32 and bf16, kernel 10 on
    fp32 and bf16, and ``slu_decide``, the port's one kernel with no TPU
    counterpart.  Every grid has more than one block along each axis the
    kernel tiles."""
    from repro_torch.kernels import graph_cond as GC
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.kernels import quant as Q

    entries: Dict[str, Tuple[Callable, Callable]] = {}
    geoms = conv_lint_geometries()
    for kind, geom in geoms.items():
        entries.update(_conv_entries(kind, geom))
    entries.update(_conv_entries("body", geoms["body"], wide=True))

    def psg_codes(dev):
        g = np.random.default_rng([LINT_SEED, 5])
        return (_ints(g, (1024, 256), 7, torch.int8, dev),
                _ints(g, (1024, 256), 511, torch.int16, dev),
                _ints(g, (1024, 256), 127, torch.int8, dev),
                _ints(g, (1024, 256), 32767, torch.int16, dev))

    def psg_sign_args(dev):
        xm, gm, xq, gq = psg_codes("cpu")
        pred = PM.predictor_matmul_plain(xm, gm)
        tau = PSGConfig().beta * pred.abs().amax()
        return tuple(t.to(dev) for t in (pred, xq, gq, tau))

    entries["predictor_matmul"] = (PM.predictor_matmul,
                                   lambda dev: psg_codes(dev)[:2])
    entries["psg_grad_w"] = (PM.psg_grad_w, psg_sign_args)
    entries.update(_flash_entries(torch.float32))
    entries.update(_flash_entries(torch.bfloat16))
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "[bf16]")):
        entries[f"quantize{tag}"] = (
            lambda x: Q.quantize(x, 8),
            lambda dev, dtype=dtype: (_normal(
                np.random.default_rng([LINT_SEED, 10]), (512, 1024), dev,
                dtype),))

    def decide_args(dev):
        g = np.random.default_rng([LINT_SEED, 11])
        return (torch.from_numpy(g.random(4096, np.float32)).to(dev),
                torch.from_numpy(g.random(4096, np.float32)).to(dev))

    entries["slu_decide"] = (GC.slu_decide, decide_args)
    return entries


# the accumulators of each launch, by kernel: int32 MMA sums exact per byte
# plane, int64 where splits, planes or flushes meet, fp32 where the kernel
# sums floats; () where the launch sums nothing (a layout pass, a select, a
# max, a rounding)
_MMA_SUMS = ("int32", "int64")


def kernel_acc_dtypes() -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """Declared accumulator dtypes per shipped kernel (the base name of a
    :func:`shipped_kernels` key), for each ``__global__`` function it
    launches (``csrc/*.cu``, ``csrc/tc.cuh``).

    The contract the linters hold the kernels to: every shipped kernel
    declares one (``analysis/precision_lint``), every declared dtype is at
    least 32 bits, and every launch the kernel lint records on the card
    has an entry (``analysis/kernel_lint``).  Narrow operands are a
    bandwidth story, never an accumulation story (the lesson of the reference's dx backward).
    """
    return {
        "conv_fwd": {"wt_tapmajor_kernel": (),
                     "conv_fwd_mma_kernel": ("int32",),
                     "conv_fwd_kernel": ("float32",)},
        "conv_grad_x": {"wt_dx_kernel": (),
                        "conv_dx_mma_kernel": _MMA_SUMS,
                        "conv_grad_x_kernel": ("float32",)},
        "conv_grad_w_predictor": {"grid_kmajor_kernel": (),
                                  "conv_pred_mma_kernel": _MMA_SUMS,
                                  "ll_to_f32_kernel": ()},
        "conv_grad_w": {"grid_kmajor_kernel": (),
                        "conv_sign_mma_kernel": _MMA_SUMS,
                        "conv_select_kernel": ("int32",)},
        "predictor_matmul": {"kmajor_kernel": (),
                             "pred_mma_kernel": _MMA_SUMS,
                             "ll_to_f32_kernel": ()},
        "psg_grad_w": {"kmajor_kernel": (),
                       "sign_mma_kernel": _MMA_SUMS,
                       "select_kernel": ("int32",)},
        "flash_fwd": {"flash_fwd_mma_kernel": ("float32",),
                      "flash_fwd_kernel": ("float32",)},
        "flash_bwd_dq": {"flash_bwd_dq_mma_kernel": ("float32",),
                         "flash_bwd_dq_kernel": ("float32",)},
        "flash_bwd_dkv": {"kmajor_kernel": (),
                          "flash_bwd_dkv_mma_kernel": ("float32",)
                          + _MMA_SUMS,
                          "flash_bwd_dkv_kernel": ("float32",) + _MMA_SUMS},
        "quantize": {"absmax_kernel": (), "quantize_kernel": ()},
        "slu_decide": {"slu_decide_kernel": ()},
    }
