"""The fused implicit-GEMM conv path against the materialized im2col path:
the bytes each moves and the device time of each (the JAX package's
``benchmarks/bench_conv.py``).

    python -m repro_torch.launch.bench_run --only conv [--device cpu]
    python -m repro_torch.launch.bench_run --json-conv PATH [--device cpu]

The quantity of record is a byte count per path, split into the
reference's three components (``assert_complete`` holds every path to them
and to a total that reconciles; ``bench_run --json-conv`` exits 1
otherwise).  The count models the port's own program, one term per pass
that it makes over device memory, read from the code: each PyTorch op is
charged the bytes of every tensor it takes and returns, and each CUDA
launch the bytes its blocks load from and store to device memory (rows
past an operand's end are zero-filled in shared memory, not read; 0-d
scales a kernel reads are not charged).  It is a model of the launches,
not a measured DRAM count: at the ResNet widths most operands fit the
H100's 50 MB L2, so the card may move fewer bytes than the model says.

``fwd_x``   forward activation traffic;
``bwd_x``   weight-gradient side: the PSG code grids of x (or of the patch
            tensor) and of gy, and the kernels' staging of them;
``bwd_dx``  input-gradient side: gy's 16-bit grid, the dx kernel or GEMM,
            and whatever folds or crops dx back to x's shape.

Weight-shaped traffic (the weights, their codes and kernel copies, the
weight gradient's sums, signs and flags), the forward output and the 0-d
ops go to ``excluded_weights``, ``excluded_fwd_out`` and
``excluded_scalars``, outside ``total``, as the reference leaves weights
and the forward output out.  The fused path also records
``bwd_dx_col2im_demoted``: the per-tap col2im loop of the port's reference
backend (``kernels/ref.conv_grad_x_ref``), outside ``total``.

Fused path (``core/psg.PSGConv2d``, ``core/psg.py:67-108``):

=============================  =======  ===================================
term                           comp.    code
=============================  =======  ===================================
pad x (``F.pad``)              fwd_x    ``psg.py:257``
codes(xp) 8 bit                fwd_x    ``psg.py:80``, ``quant.py:63-68``
kernel 1: x codes per dout     fwd_x    ``conv.py:436-441``, ``conv.cu:196``
tile of bn = 16/32/64 rows
codes(gy) 16 bit               bwd_dx   ``psg.py:96``
kernel 2: g codes a block      bwd_dx   ``conv.py:493-507``, ``conv.cu:513``
stages, fp32 dx write
crop of dxp (pad backward) or  bwd_dx   ``psg.py:257-258``
the subsample's backward
``_wgrad_codes``: 4 grids      bwd_x    ``ops.py:84-95``
kernel 3: pre-passes, MMA      bwd_x    ``conv.cu:1041-1057``, ``:785-805``
staging
kernel 4: the same             bwd_x    ``conv.cu:1181-1205``
=============================  =======  ===================================

im2col path (``psg.py:283`` -> ``PSGMatmul``, ``psg.py:111``):

=============================  =======  ===================================
pad x                          fwd_x    ``psg.py:257``
``conv_patches`` (a stack)     fwd_x    ``kernels/conv.py:91-104``
quantize(x2) fp32, ``xq @ wq``  fwd_x    ``psg.py:120-125``
quantize(gy), ``gq @ wq^T``    bwd_dx   ``psg.py:133-134``
``_wgrad_codes`` on patches    bwd_x    ``ops.py:110``
kernels 5-6: pre-passes, MMA   bwd_x    ``psg_matmul.cu:370-383``, ``:145``
staging
the fold: per tap the slice    bwd_dx   autograd of ``conv_patches``
backwards, k*k - 1 adds, the
crop
=============================  =======  ===================================

Where the terms differ from the reference's formula, and why:

* codes and fake-quantizations are charged op by op as PyTorch runs them:
  ``x.abs()``, ``amax``, the division, ``round``, ``clamp`` and the cast
  (41 bytes an fp32 element for int8 codes, 42 for int16, 44 for the fp32
  fake-quantized ``xq`` the im2col forward writes), where the reference
  charges two reads and one code write;
* the PSG code grids are four separate passes, each with its own max
  (``ops._wgrad_codes``), where the reference charges two reads;
* gy is charged on both paths wherever the port reads it: the 16-bit grid
  of the dx side and both grids of the weight-gradient side;
* the kernels' staging is counted per block of their launch grids: kernel 1
  stages a slab of input rows plus its halo per block and dout tile; kernel
  2 stages g rows plus halo per block, channel tile and stride phase;
  kernels 3-6 stage 128-position chunks of their K-major copies per split;
* the im2col fold is autograd's: one or two ``slice_backward`` per tap, each
  a zero-fill and a copy of x's padded shape, then ``k*k - 1`` adds.

Times: each shape row runs forward and the backward over both operands on
each path, timed by ``bench_common.time_us`` (CUDA events on the card, TF32
off).  ``_paper_totals`` adds ``device_ms_per_step``: the 8 unique ResNet-74
batch-128 geometries timed once each and weighted by their multiplicity
over the 75 sites (null off the card); ``device_busy_ms_per_step``, the
same from ``bench_common.device_profile`` (the union of the profiled
device events of one call: the event span also holds the time the card
waits for the host, which launches about a hundred ops a site); and
``implied_tb_s`` and ``implied_tb_s_busy``, the model's bytes over each,
printed and not gated: where the operands live in L2 they may pass the
card's 3.35 TB/s.  The same profiles hold ``fused_launches`` and
``im2col_launches``, the grids and blocks of the plans that the kernel
terms count, against the card's launches at every geometry
(``launches_held``): a kernel retiled without its model fails the record.
``profiles_discarded`` counts the profiler sessions thrown away because
their call lost device records.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.paper_cnns import ConvShape, resnet_conv_shapes
from repro_torch.core.device import resolve_device
from repro_torch.kernels.conv import (FWD_K_STEP, MAX_SPLIT_POSITIONS,
                                      PRED_BLOCK, conv_grad_x_k_bytes,
                                      fallback_blocks, pred_grid)
from repro_torch.kernels.psg_matmul import PRED_STAGE_TOKENS, tile_grid
from repro_torch.launch.bench_common import (Launch, Term, check_launches,
                                             csv_row, device_label,
                                             device_profile, one_per_kind,
                                             sync, time_us)
from repro_torch.launch.train import _fp32_is_fp32

FP32, INT8, INT16, INT64 = 4, 1, 2, 8

#: every path's accounting must report exactly these traffic components
#: (plus informational extras outside ``total``)
REQUIRED_COMPONENTS = ("fwd_x", "bwd_x", "bwd_dx")
EXCLUDED = ("excluded_weights", "excluded_fwd_out", "excluded_scalars")
W_, Y_, S_ = EXCLUDED

SMS = 132               # H100 SXM: the launch plans aim at two blocks an SM
CODES_SCALAR_BYTES = 32     # core/quant.codes: amax out, scale, division
QUANT_SCALAR_BYTES = 36     # core/quant.quantize: the same and the multiply
PROBE_SCALAR_BYTES = 48     # the backward's MAC count and probe gradient


class IncompleteAccountingError(RuntimeError):
    """A conv path's byte accounting is missing a traffic direction."""


def assert_complete(acct: Dict[str, int], path: str) -> None:
    """Fail loudly if ``acct`` omits a traffic direction or its total
    does not reconcile with the components (bench_run --json-conv gate)."""
    missing = [c for c in REQUIRED_COMPONENTS if not acct.get(c, 0) > 0]
    if missing:
        raise IncompleteAccountingError(
            f"{path}: byte accounting incomplete: missing/zero "
            f"components {missing} (have {sorted(acct)})")
    if acct.get("total") != sum(acct[c] for c in REQUIRED_COMPONENTS):
        raise IncompleteAccountingError(
            f"{path}: total {acct.get('total')} != sum of "
            f"{REQUIRED_COMPONENTS}")


def codes_terms(comp: str, what: str, n: int, code_bytes: int
                ) -> List[Term]:
    """``core/quant.codes`` on ``n`` fp32 elements: abs (read, write), amax
    (read), the division, round and clamp (read, write each), the cast to
    codes (read fp32, write codes), and its 0-d ops."""
    return [Term(comp, what, (40 + code_bytes) * n),
            Term(S_, what, CODES_SCALAR_BYTES)]


def quantize_terms(comp: str, what: str, n: int) -> List[Term]:
    """``core/quant.quantize`` of ``n`` fp32 elements: as
    :func:`codes_terms`, with ``q * s`` in place of the cast."""
    return [Term(comp, what, 44 * n), Term(S_, what, QUANT_SCALAR_BYTES)]


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Site:
    """A conv site as ``core/psg.conv2d`` hands it on: the kernels' operand
    ``(B, Hp, Wp, C)`` (padded, or the ``k < stride`` subsample), its
    stride, the output extent and the input ``x``'s extent."""
    B: int
    H: int          # x
    C: int
    dout: int
    k: int
    s: int          # the operand's stride (1 after a subsample)
    Hp: int         # the operand
    ho: int
    pad: int
    sub: int        # the subsample's stride, or 0

    @property
    def n_x(self) -> int:
        return self.B * self.H * self.H * self.C

    @property
    def n_xp(self) -> int:
        return self.B * self.Hp * self.Hp * self.C

    @property
    def n_g(self) -> int:
        return self.B * self.ho * self.ho * self.dout

    @property
    def n_w(self) -> int:
        return self.k * self.k * self.C * self.dout

    @property
    def n_patch(self) -> int:
        return self.B * self.ho * self.ho * self.k * self.k * self.C


def site_of(shape: ConvShape) -> Site:
    k, s = shape.k, shape.stride
    if k < s:                       # psg.conv2d: a pre-subsampled 1x1
        hs = -(-shape.hw // s)
        return Site(shape.batch, shape.hw, shape.cin, shape.cout, k, 1, hs,
                    hs, 0, s)
    pad = k // 2
    hp = shape.hw + 2 * pad
    return Site(shape.batch, shape.hw, shape.cin, shape.cout, k, s, hp,
                (hp - k) // s + 1, pad, 0)


def _pad_terms(g: Site) -> List[Term]:
    if not g.pad:
        return []
    return [Term("fwd_x", "pad x", FP32 * (g.n_x + g.n_xp))]


def _unpad_terms(g: Site) -> List[Term]:
    """dx back to x's shape: the pad's backward (a crop), or the
    subsample's (two ``slice_backward``, each a zero-fill and a copy)."""
    if g.pad:
        return [Term("bwd_dx", "crop dxp", FP32 * (g.n_xp + g.n_x))]
    if g.sub:
        mid = g.B * g.Hp * g.H * g.C
        return [Term("bwd_dx", "subsample backward",
                     FP32 * (g.n_xp + mid + mid + g.n_x))]
    return []


# ---------------------------------------------------------------------------
# kernels 1-4: launch plans of csrc/conv.cu, bytes a block moves
# ---------------------------------------------------------------------------


def _tile_plan(B: int, rows: int, cols: int, tiles_n: int
               ) -> Tuple[int, int, int, int]:
    """``plan_fwd`` / ``plan_dx``: ``(warps, R, NI, tpi)``, the most warps
    (8, 4, 2; 16 positions each) that still give about two blocks an SM."""
    def tile(w):
        bmp = 16 * w
        if rows * cols <= bmp:
            r, ni, tpi = rows, bmp // (rows * cols), 1
        else:
            r, ni = bmp // cols, 1
            tpi = -(-rows // r)
        return r, ni, tpi, -(-B // ni) * tpi * tiles_n
    warps = 8
    while warps > 2 and 16 * (warps // 2) >= cols:
        if tile(warps)[3] >= 2 * SMS:
            break
        warps //= 2
    r, ni, tpi, _ = tile(warps)
    return warps, r, ni, tpi


def fwd_plan(g: Site) -> Dict[str, int]:
    """Kernel 1's launch (``conv_fwd_codes``, ``plan_fwd``): the dout tile
    ``bn``, ``Kp``, and the tile of ``R`` output rows of ``NI`` images."""
    bn = 16 if g.dout <= 16 else 32 if g.dout <= 32 else 64
    kp = -(-g.k * g.k * g.C // FWD_K_STEP) * FWD_K_STEP
    n_j = -(-g.dout // bn)
    warps, R, NI, tpi = _tile_plan(g.B, g.ho, g.ho, n_j)
    return {"bn": bn, "kp": kp, "n_j": n_j, "warps": warps, "R": R,
            "NI": NI, "tpi": tpi, "rin": (R - 1) * g.s + g.k,
            "tiles": -(-g.B // NI) * tpi}


def fwd_tile_x_bytes(g: Site, p: Dict[str, int], tile: int) -> int:
    """x code bytes block ``(tile, j)`` stages, for any dout tile ``j``:
    each image's slab of ``rin`` padded rows, clipped at the bottom."""
    b0, oh0 = (tile // p["tpi"]) * p["NI"], (tile % p["tpi"]) * p["R"]
    rows = min(p["rin"], g.Hp - oh0 * g.s)
    return min(p["NI"], g.B - b0) * rows * g.Hp * g.C * INT8


def kernel1_terms(g: Site) -> List[Term]:
    p = fwd_plan(g)
    src = "conv_fwd"
    x = p["n_j"] * sum(fwd_tile_x_bytes(g, p, t) for t in range(p["tiles"]))
    rows = p["n_j"] * p["bn"]
    return [Term("fwd_x", "kernel 1 x codes", x, src),
            Term(W_, "kernel 1 wt scratch", g.n_w + rows * p["kp"], src),
            Term(W_, "kernel 1 weight tiles",
                 p["tiles"] * rows * p["kp"], src),
            Term(Y_, "kernel 1 y", FP32 * g.n_g, src)]


def dx_plan(g: Site) -> Dict[str, int]:
    """Kernel 2's launch (``conv_grad_x_codes``, ``plan_dx``)."""
    s, k = g.s, g.k
    bn = 16 if g.C <= 16 else 32 if g.C <= 32 else 64
    nu = nv = -(-g.Hp // s)
    amax = (k - 1) // s
    n_c = -(-g.C // bn)
    warps, R, NI, tpi = _tile_plan(g.B, nu, nv, n_c * s * s)
    return {"bn": bn, "n_c": n_c, "nu": nu, "nv": nv, "amax": amax,
            "Wg": nv + amax, "warps": warps, "R": R, "NI": NI, "tpi": tpi,
            "rin": R + amax, "tiles": -(-g.B // NI) * tpi,
            "kp": conv_grad_x_k_bytes(k, s, g.dout)}


def dx_tile_g_bytes(g: Site, p: Dict[str, int], tile: int) -> int:
    """g code bytes a block of lattice tile ``tile`` stages (any channel
    tile and phase): lattice rows ``u0 - amax .. u0 + R - 1`` and columns
    ``-amax .. nv - 1`` of each image, where they fall in the output."""
    b0, u0 = (tile // p["tpi"]) * p["NI"], (tile % p["tpi"]) * p["R"]
    r_lo, r_hi = max(0, u0 - p["amax"]), min(g.ho, u0 + p["R"])
    cols = min(p["nv"], g.ho)
    return (min(p["NI"], g.B - b0) * max(0, r_hi - r_lo) * cols
            * g.dout * INT16)


def _phase_k(g: Site, z: int, kp_of) -> int:
    s, k = g.s, g.k
    pi, pj = z // s, z % s
    na, nb = -(-(k - pi) // s), -(-(k - pj) // s)
    return kp_of(na * nb)


def kernel2_terms(g: Site) -> List[Term]:
    p = dx_plan(g)
    src = "conv_grad_x"
    per_tile = sum(dx_tile_g_bytes(g, p, t) for t in range(p["tiles"]))
    rows = p["n_c"] * p["bn"]
    d16 = -(-g.dout // 16) * 16

    def kp_of(taps):
        return -(-taps * d16 // FWD_K_STEP) * FWD_K_STEP
    w_tiles = p["tiles"] * p["n_c"] * p["bn"] * sum(
        _phase_k(g, z, kp_of) for z in range(g.s * g.s))
    return [Term("bwd_dx", "kernel 2 g codes",
                 p["n_c"] * g.s * g.s * per_tile, src),
            Term("bwd_dx", "kernel 2 dx", FP32 * g.n_xp, src),
            Term(W_, "kernel 2 phase weights",
                 g.n_w + g.s * g.s * rows * p["kp"], src),
            Term(W_, "kernel 2 weight tiles", w_tiles, src)]


def wgrad_plan(g: Site) -> Dict[str, int]:
    """Kernels 3-4's scratch (``kernels/conv._wgrad_scratch``) and MMA
    launch (``wgrad_plan``, ``launch_code_mma``)."""
    k, s = g.k, g.s
    hq, wq, halo = pred_grid(g.Hp, g.Hp, k, s)
    n_pad = max(1, -(-g.B * hq * wq // PRED_BLOCK)) * PRED_BLOCK
    x_pad = -(-(n_pad + halo + 4 + 15) // PRED_BLOCK) * PRED_BLOCK
    mt, np_ = (2 if g.C > 16 else 1), (2 if g.dout > 16 else 1)
    mb, nb = 16 * mt, 16 * np_
    ti, tj = -(-g.C // mb), -(-g.dout // nb)
    kts = n_pad // 128
    splits = -(-2 * SMS // (ti * tj))
    most = kts // 2 if kts // 2 > 1 else 1
    least = -(-kts // (MAX_SPLIT_POSITIONS // 128))
    splits = max(min(splits, most), least)
    per = -(-kts // splits)
    return {"hq": hq, "wq": wq, "n_pad": n_pad, "x_pad": x_pad,
            "mb": mb, "nb": nb, "ti": ti, "tj": tj, "kts": kts,
            "per": per, "splits": -(-kts // per),
            "xw": -(-(128 + halo + 4) // 16) * 16,
            "ksplit": 1 if k * k >= 4 else 4 // (k * k),
            "acc": -(-8 * g.n_w // 128) * 128}


def wgrad_stage_bytes(g: Site, p: Dict[str, int]) -> int:
    """Bytes every MMA block of kernels 3-4 stages over its stages: the g
    planes' rows of its dout tile and the x copies' rows of its channel
    tile in every stride phase, ``128`` positions (``xw`` with the halo) a
    stage."""
    stages = sum(max(0, min(p["kts"], z * p["per"] + p["per"]) - z * p["per"])
                 for z in range(p["splits"]))
    g_rows = sum(min(p["nb"], g.dout - j * p["nb"]) for j in range(p["tj"]))
    x_rows = sum(min(p["mb"], g.C - i * p["mb"]) for i in range(p["ti"]))
    return stages * (p["ti"] * 2 * g_rows * 128
                     + p["tj"] * g.s * g.s * x_rows * p["xw"])


def _wgrad_pass_terms(g: Site, p: Dict[str, int], src: str) -> List[Term]:
    """One pass's two pre-passes and MMA staging (activations), and its
    int64 sums: zeroed, then one 8-byte atomic add per block, tap and
    element of its tile (every sum taken as nonzero)."""
    blocks = p["splits"] * p["ksplit"]
    return [Term("bwd_x", f"{src} x pre-pass",
                 g.n_xp * INT8 + g.s * g.s * g.C * p["x_pad"], src),
            Term("bwd_x", f"{src} g pre-pass",
                 g.n_g * INT16 + 2 * g.dout * p["n_pad"], src),
            Term("bwd_x", f"{src} MMA staging", wgrad_stage_bytes(g, p), src),
            Term(W_, f"{src} sums", p["acc"] + 2 * INT64 * blocks * g.n_w,
                 src)]


def kernel3_terms(g: Site) -> List[Term]:
    p = wgrad_plan(g)
    return _wgrad_pass_terms(g, p, "conv_grad_w_predictor") + [
        Term(W_, "kernel 3 rounding", (INT64 + FP32) * g.n_w,
             "conv_grad_w_predictor")]


def kernel4_terms(g: Site) -> List[Term]:
    p = wgrad_plan(g)
    _, nj = fallback_blocks(g.dout)
    return _wgrad_pass_terms(g, p, "conv_grad_w") + [
        Term(W_, "kernel 4 flags zeroed", 4 * g.k * g.k * nj, "conv_grad_w"),
        Term(W_, "kernel 4 select",
             (FP32 + INT64 + INT8) * g.n_w, "conv_grad_w")]


# ---------------------------------------------------------------------------
# kernels 5-6: launch plans of csrc/psg_matmul.cu
# ---------------------------------------------------------------------------


def mma_splits(tiles: int, kts: int) -> int:
    """``mma_splits`` of ``csrc/psg_matmul.cu``."""
    if kts <= 0:
        return 1
    splits = 1
    if tiles < SMS:
        splits = min(-(-2 * SMS // tiles), kts // 4)
    splits = max(splits, -(-kts // (MAX_SPLIT_POSITIONS // 128)), 1)
    per = -(-kts // splits)
    return -(-kts // per)


def psg_plan(n: int, din: int, dout: int) -> Dict[str, int]:
    """Kernels 5-6's scratch (``psg_matmul._scratch``) and MMA tiling:
    128 x 128 tiles from 128 output columns, else 128 x 32."""
    n_pad = -(-n // PRED_STAGE_TOKENS) * PRED_STAGE_TOKENS
    bm, bn = (128, 128) if dout >= 128 else (128, 32)
    ti, tj = -(-din // bm), -(-dout // bn)
    kts = n_pad // 128
    splits = mma_splits(ti * tj, kts)
    return {"n_pad": n_pad, "bm": bm, "bn": bn, "ti": ti, "tj": tj,
            "kts": kts, "splits": splits, "per": -(-kts // splits)}


def psg_stage_bytes(din: int, dout: int, p: Dict[str, int]) -> int:
    """Bytes every MMA block of kernels 5-6 stages: 128 tokens of its rows
    of x^T and of both g^T planes a stage."""
    stages = sum(max(0, min(p["kts"], z * p["per"] + p["per"]) - z * p["per"])
                 for z in range(p["splits"]))
    x_rows = sum(min(p["bm"], din - i * p["bm"]) for i in range(p["ti"]))
    g_rows = sum(min(p["bn"], dout - j * p["bn"]) for j in range(p["tj"]))
    return stages * 128 * (p["tj"] * x_rows + p["ti"] * 2 * g_rows)


def psg_kernel_terms(n: int, din: int, dout: int, src: str) -> List[Term]:
    """Kernel 5 (``predictor_matmul``) or 6 (``psg_grad_w``) on ``x (n,
    din)`` int8 and ``g (n, dout)`` int16 codes: the two pre-passes and
    the staging; where the tokens split, the zeroed int64 sums and one
    atomic add per block and element, then the rounding (5) or the select
    (6); else the fused epilogue."""
    p = psg_plan(n, din, dout)
    w = din * dout
    terms = [Term("bwd_x", f"{src} pre-passes",
                  n * din * INT8 + din * p["n_pad"]
                  + n * dout * INT16 + 2 * dout * p["n_pad"], src),
             Term("bwd_x", f"{src} MMA staging",
                  psg_stage_bytes(din, dout, p), src)]
    split = p["splits"] > 1
    sums = INT64 * w + 2 * INT64 * p["splits"] * w if split else 0
    if src == "predictor_matmul":
        out = (INT64 + FP32) * w if split else FP32 * w
    else:
        _, _, ni, nj = tile_grid(din, dout)
        out = 4 * ni * nj + ((FP32 + INT64 + INT8) * w + 4 * ni * nj
                             if split else (FP32 + INT8) * w)
    return terms + [Term(W_, f"{src} sums and outputs", sums + out, src)]


# ---------------------------------------------------------------------------
# the two paths
# ---------------------------------------------------------------------------


def fused_launches(shape: ConvShape) -> List[Launch]:
    """The tensor-core launches of kernels 1-4 in one fused step at
    ``shape``, from the plans that their byte terms count:
    ``_paper_totals`` holds them against the card's grids and blocks."""
    g = site_of(shape)
    f, d, w = fwd_plan(g), dx_plan(g), wgrad_plan(g)
    wgrad = ((w["tj"], w["ti"], w["splits"]),
             (32 * g.k * g.k * w["ksplit"], 1, 1))
    return [Launch("conv_fwd_mma_kernel", (f["tiles"], f["n_j"], 1),
                   (32 * f["warps"], 1, 1)),
            Launch("conv_dx_mma_kernel", (d["tiles"], d["n_c"], g.s * g.s),
                   (32 * d["warps"], 1, 1)),
            Launch("conv_pred_mma_kernel", *wgrad),
            Launch("conv_sign_mma_kernel", *wgrad)]


def im2col_launches(shape: ConvShape) -> List[Launch]:
    """Kernels 5-6's tensor-core launches in one im2col step (grids)."""
    g = site_of(shape)
    p = psg_plan(g.B * g.ho * g.ho, g.k * g.k * g.C, g.dout)
    grid = (p["tj"], p["ti"], p["splits"])
    return [Launch("pred_mma_kernel", grid), Launch("sign_mma_kernel", grid)]


def _wgrad_tail(g: Site, n_w: int, n_flags: int) -> List[Term]:
    """The weight gradient's PyTorch ops after the kernels: ``tau``
    (abs, amax, ``beta *``), ``sign.float()``, the flags' mean, and the
    probe's MAC count and gradient."""
    return [Term(W_, "tau", (8 + 4) * n_w), Term(S_, "tau", 4 + 8),
            Term(W_, "sign.float()", (INT8 + FP32) * n_w),
            Term(W_, "flags mean", 12 * n_flags), Term(S_, "flags mean", 4),
            Term(S_, "probe", PROBE_SCALAR_BYTES)]


def fused_terms(shape: ConvShape) -> List[Term]:
    """Every pass of the fused path's forward and backward over both
    operands at ``shape`` (``core/psg.conv2d`` with ``fused_conv`` on)."""
    g = site_of(shape)
    _, nj = fallback_blocks(g.dout)
    terms = _pad_terms(g)
    terms += codes_terms("fwd_x", "codes(xp)", g.n_xp, INT8)
    terms += [Term(S_, "probe", 8)]
    terms += codes_terms(W_, "codes(w)", g.n_w, INT8)
    terms += kernel1_terms(g)
    terms += codes_terms("bwd_dx", "codes(gy) 16 bit", g.n_g, INT16)
    terms += kernel2_terms(g)
    for what, n, cb in (("x msb", g.n_xp, INT8), ("g msb", g.n_g, INT16),
                        ("x full", g.n_xp, INT8), ("g full", g.n_g, INT16)):
        terms += codes_terms("bwd_x", f"wgrad codes {what}", n, cb)
    terms += kernel3_terms(g) + kernel4_terms(g)
    terms += _wgrad_tail(g, g.n_w, g.k * g.k * nj)
    return terms + _unpad_terms(g)


def _fold_terms(g: Site) -> List[Term]:
    """Autograd's fold of the patch cotangent into dxp: each tap's strided
    slices run ``slice_backward`` along W, then H (a full-range slice has
    none), and the k*k taps' gradients meet in ``k*k - 1`` adds."""
    tap = g.B * g.ho * g.ho * g.C
    mid = g.B * g.ho * g.Hp * g.C
    full = g.s == 1 and g.ho == g.Hp          # the slices of a 1x1 conv
    per_tap = 0 if full else FP32 * (tap + mid + mid + g.n_xp)
    adds = FP32 * 3 * g.n_xp * (g.k * g.k - 1)
    return [Term("bwd_dx", "fold: slice backwards", g.k * g.k * per_tap),
            Term("bwd_dx", "fold: adds", adds)]


def im2col_terms(shape: ConvShape) -> List[Term]:
    """Every pass of the im2col path's forward and backward over both
    operands at ``shape`` (``core/psg.conv2d`` with ``fused_conv`` off)."""
    g = site_of(shape)
    n, din, dout = g.B * g.ho * g.ho, g.k * g.k * g.C, g.dout
    _, _, ni, nj = tile_grid(din, dout)
    terms = _pad_terms(g)
    terms += [Term("fwd_x", "conv_patches", 2 * FP32 * g.n_patch),
              Term(S_, "probe", 8)]
    terms += quantize_terms("fwd_x", "quantize(x2)", g.n_patch)
    terms += quantize_terms(W_, "quantize(w)", g.n_w)
    terms += [Term("fwd_x", "xq @ wq: xq", FP32 * g.n_patch),
              Term(W_, "xq @ wq: wq", FP32 * g.n_w),
              Term(Y_, "xq @ wq: y", FP32 * g.n_g)]
    terms += quantize_terms("bwd_dx", "quantize(gy)", g.n_g)
    terms += quantize_terms(W_, "quantize(w)", g.n_w)
    terms += [Term("bwd_dx", "gq @ wq^T", FP32 * (g.n_g + g.n_patch)),
              Term(W_, "gq @ wq^T: wq", FP32 * g.n_w)]
    for what, m, cb in (("x msb", g.n_patch, INT8), ("g msb", g.n_g, INT16),
                        ("x full", g.n_patch, INT8),
                        ("g full", g.n_g, INT16)):
        terms += codes_terms("bwd_x", f"wgrad codes {what}", m, cb)
    terms += psg_kernel_terms(n, din, dout, "predictor_matmul")
    terms += psg_kernel_terms(n, din, dout, "psg_grad_w")
    terms += _wgrad_tail(g, g.n_w, ni * nj)
    return terms + _fold_terms(g) + _unpad_terms(g)


def col2im_demoted_bytes(shape: ConvShape) -> int:
    """Activation bytes of the per-tap col2im dx of the reference backend
    (``kernels/ref.conv_grad_x_ref`` on ``conv_grad_x_plain``): ``gc.float()
    * sg``, the zeroed dx, and per tap ``gq @ w_t^T`` and the window's
    read-modify-write."""
    g = site_of(shape)
    win = g.B * g.ho * g.ho * g.C
    return (FP32 * 4 * g.n_g - 2 * g.n_g + FP32 * g.n_xp
            + g.k * g.k * FP32 * (g.n_g + 4 * win))


def summarize(terms: List[Term]) -> Dict[str, int]:
    acct: Dict[str, int] = {c: 0 for c in (*REQUIRED_COMPONENTS, "total",
                                           *EXCLUDED)}
    for t in terms:
        acct[t.comp] += t.nbytes
    acct["total"] = sum(acct[c] for c in REQUIRED_COMPONENTS)
    return acct


def im2col_bytes(shape: ConvShape) -> Dict[str, int]:
    """Bytes the materialized path moves at one conv site, per component."""
    return summarize(im2col_terms(shape))


def fused_bytes(shape: ConvShape) -> Dict[str, int]:
    """Bytes the implicit-GEMM path moves at one conv site, per component,
    with ``bwd_dx_col2im_demoted`` beside them (outside ``total``)."""
    acct = summarize(fused_terms(shape))
    acct["bwd_dx_col2im_demoted"] = col2im_demoted_bytes(shape)
    return acct


def _ratios(b_im2col: Dict[str, int], b_fused: Dict[str, int]) -> Dict:
    bwd_i = b_im2col["bwd_x"] + b_im2col["bwd_dx"]
    bwd_f = b_fused["bwd_x"] + b_fused["bwd_dx"]
    return {"bytes_ratio": b_im2col["total"] / b_fused["total"],
            "backward_bytes_ratio": bwd_i / bwd_f,
            "dx_bytes_ratio": b_im2col["bwd_dx"] / b_fused["bwd_dx"]}


# ---------------------------------------------------------------------------
# the timed program
# ---------------------------------------------------------------------------


def conv_inputs(shape: ConvShape, dev: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x, w, gy)`` fp32 from a seed of the geometry (numpy, so both
    devices see the same values)."""
    c = shape
    rng = np.random.default_rng([c.hw, c.cin, c.cout, c.k, c.stride])
    ho = c.hw_out

    def normal(*sh, scale):
        return torch.from_numpy((rng.standard_normal(sh) * scale)
                                .astype(np.float32)).to(dev)
    return (normal(c.batch, c.hw, c.hw, c.cin, scale=0.5),
            normal(c.k * c.k * c.cin, c.cout, scale=0.1),
            normal(c.batch, ho, ho, c.cout, scale=0.01))


def conv_step(shape: ConvShape, fused: bool):
    """The program both byte models describe: the PSG conv's forward and
    the gradients of ``sum(y * gy)`` over both operands."""
    from repro_torch.core import psg
    from repro_torch.core.config import PSGConfig

    cfg = PSGConfig(enabled=True, fused_conv=fused)

    def step(w, x, gy):
        w, x = w.detach().requires_grad_(), x.detach().requires_grad_()
        with torch.enable_grad():
            with psg.enable(cfg):
                y = psg.conv2d(x, w, k=shape.k, stride=shape.stride)
            return torch.autograd.grad(y, (w, x), gy)
    return step


def _time_paths(shape: ConvShape, dev: torch.device, reps: int = 3
                ) -> Tuple[float, float]:
    x, w, gy = conv_inputs(shape, dev)
    us_i, _ = time_us(conv_step(shape, False), w, x, gy, reps=reps)
    us_f, _ = time_us(conv_step(shape, True), w, x, gy, reps=reps)
    return us_i, us_f


def _shape_rows(fast: bool, device=None) -> List[Dict]:
    dev = resolve_device(device)
    _fp32_is_fp32()
    batch = 2 if fast else 8
    convs = resnet_conv_shapes(depth=74, width=16, batch=batch)
    if fast:                                  # one shape of each kind
        convs = one_per_kind(convs)
    rows = []
    for c in convs:
        us_im2col, us_fused = _time_paths(c, dev)
        b_im2col, b_fused = im2col_bytes(c), fused_bytes(c)
        assert_complete(b_im2col, f"im2col/{c.kind}")
        assert_complete(b_fused, f"fused/{c.kind}")
        rows.append({
            "batch": c.batch, "hw": c.hw, "cin": c.cin, "cout": c.cout,
            "k": c.k, "stride": c.stride, "kind": c.kind,
            "us_im2col": us_im2col, "us_fused": us_fused,
            "im2col_bytes": b_im2col, "fused_bytes": b_fused,
            **_ratios(b_im2col, b_fused)})
    return rows


def _paper_totals(depth: int = 74, width: int = 16, batch: int = 128,
                  device=None) -> Dict:
    """Per-training-step byte totals over every conv site (with
    multiplicity) of the paper's ResNet-74 at batch 128; the acceptance
    quantity is ``backward_bytes_ratio`` (bwd_x + bwd_dx).  On the card
    also the device ms of a step's convs on each path and the bytes over
    that time; null on the CPU (``device=None`` times nothing)."""
    sites = resnet_conv_shapes(depth=depth, width=width, batch=batch,
                               unique=False)
    b_im2col: Dict[str, int] = collections.Counter()
    b_fused: Dict[str, int] = collections.Counter()
    for c in sites:
        b_im2col.update(im2col_bytes(c))
        b_fused.update(fused_bytes(c))
    b_im2col, b_fused = dict(b_im2col), dict(b_fused)
    assert_complete(b_im2col, "im2col/paper_totals")
    assert_complete(b_fused, "fused/paper_totals")
    ms: Dict[str, Optional[float]] = {"im2col": None, "fused": None}
    busy = dict(ms)
    held: Optional[Dict[str, int]] = None
    discarded: Optional[int] = None
    dev = None if device is None else resolve_device(device)
    if dev is not None and dev.type == "cuda":
        _fp32_is_fp32()
        ms, busy = {"im2col": 0.0, "fused": 0.0}, {"im2col": 0.0, "fused": 0.0}
        held, discarded = collections.Counter(), 0
        for c, mult in collections.Counter(sites).items():
            us_i, us_f = _time_paths(c, dev)
            ms["im2col"] += mult * us_i / 1e3
            ms["fused"] += mult * us_f / 1e3
            x, w, gy = conv_inputs(c, dev)
            for p in busy:
                prof = device_profile(conv_step(c, p == "fused"), w, x, gy)
                busy[p] += mult * prof.busy_ms
                discarded += prof.discarded
                model = fused_launches(c) if p == "fused" \
                    else im2col_launches(c)
                held.update(check_launches(model, prof.launches,
                                           f"{p} {c}"))
        held = dict(held)
    total = {"im2col": b_im2col["total"], "fused": b_fused["total"]}

    def rate(t):
        return {p: None if t[p] is None else total[p] / t[p] / 1e9 for p in t}
    return {"depth": depth, "width": width, "batch": batch,
            "conv_sites": len(sites),
            "unique_geometries": len(set(sites)),
            "im2col_bytes_per_step": b_im2col,
            "fused_bytes_per_step": b_fused,
            **_ratios(b_im2col, b_fused),
            "device_ms_per_step": ms,
            "time_ratio": None if ms["fused"] is None
            else ms["im2col"] / ms["fused"],
            "device_busy_ms_per_step": busy,
            "busy_ratio": None if busy["fused"] is None
            else busy["im2col"] / busy["fused"],
            "launches_held": held, "profiles_discarded": discarded,
            "implied_tb_s": rate(ms), "implied_tb_s_busy": rate(busy)}


def _train_proxy(fast: bool, device=None) -> Dict:
    """Executed steps per second of a short ResNet training A/B with
    ``fused_conv`` on and off, on ``device``; the host's clock around
    steps that end in a synchronize, after one warm-up step (which builds
    the kernels on the card)."""
    from repro_torch.configs.paper_cnns import cnn_model
    from repro_torch.core.config import (E2TrainConfig, Experiment,
                                         PSGConfig, TrainConfig)
    from repro_torch.data.synthetic import GaussianImageTask, \
        make_image_batch
    from repro_torch.training.train_step import init_train_state
    from repro_torch.training.trainer import Trainer

    dev = resolve_device(device)
    _fp32_is_fp32()
    depth, width, batch, steps = (8, 8, 4, 2) if fast else (14, 16, 8, 4)
    task = GaussianImageTask(num_classes=10, snr=2.0)
    out: Dict = {"depth": depth, "width": width, "batch": batch,
                 "steps": steps, "device": device_label(dev),
                 "note": "loop-level A/B; the byte counts are the "
                         "quantity of record"}
    for label, fused in (("im2col", False), ("fused", True)):
        exp = Experiment(
            model=cnn_model(f"resnet{depth}", depth, width=width),
            e2=E2TrainConfig(psg=PSGConfig(enabled=True, swa=False,
                                           fused_conv=fused)),
            train=TrainConfig(global_batch=batch, lr=0.03, optimizer="psg",
                              total_steps=1000, schedule="constant"),
            task="cifar_cnn")
        tr = Trainer(exp, init_train_state(exp, seed=0, device=dev),
                     lambda s, sh: make_image_batch(task, 0, s, sh, batch,
                                                    dev), device=dev)
        tr.run(1)                                     # warm-up, the build
        sync(dev)
        t0 = time.perf_counter()
        tr.run(steps)
        sync(dev)
        out[f"{label}_steps_per_s"] = steps / (time.perf_counter() - t0)
    out["speedup"] = out["fused_steps_per_s"] / out["im2col_steps_per_s"]
    return out


def conv_json(fast: bool = True, device=None) -> dict:
    """The conv record.  Raises :class:`IncompleteAccountingError` if any
    path omits a traffic direction (``bench_run --json-conv`` exits 1)."""
    dev = resolve_device(device)
    return {"device": device_label(dev),
            "paper_resnet74_batch128": _paper_totals(device=dev),
            "shapes": _shape_rows(fast, dev),
            "train_proxy": _train_proxy(fast, dev)}


def run(fast: bool = True, device=None):
    """CSV rows for ``bench_run``."""
    dev = resolve_device(device)
    return rows(_paper_totals(device=dev), _shape_rows(fast, dev))


def rows(totals: Dict, shape_rows: List[Dict]):
    """The CSV rows of a record's ``paper_resnet74_batch128`` and
    ``shapes``."""
    ms = totals["device_ms_per_step"]
    yield csv_row("conv/paper_resnet74_batch128",
                  0.0 if ms["fused"] is None else 1e3 * ms["fused"],
                  f"bytes_ratio={totals['bytes_ratio']:.2f};"
                  f"backward_bytes_ratio={totals['backward_bytes_ratio']:.2f};"
                  f"im2col_GB={totals['im2col_bytes_per_step']['total']/1e9:.2f};"
                  f"fused_GB={totals['fused_bytes_per_step']['total']/1e9:.2f}"
                  + ("" if ms["fused"] is None else
                     f";im2col_ms={ms['im2col']:.3f};fused_ms={ms['fused']:.3f}"))
    for r in shape_rows:
        yield csv_row(
            f"conv/{r['kind']}/{r['batch']}x{r['hw']}x{r['cin']}-"
            f"{r['cout']}k{r['k']}s{r['stride']}",
            r["us_fused"],
            f"im2col_us={r['us_im2col']:.1f};"
            f"bytes_ratio={r['bytes_ratio']:.2f};"
            f"backward_bytes_ratio={r['backward_bytes_ratio']:.2f}")
