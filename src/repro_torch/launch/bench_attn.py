"""The PSG flash-attention path against the materialized ``(S, T)`` path:
the bytes each moves and the device time of each (the JAX package's
``benchmarks/bench_attn.py``).

    python -m repro_torch.launch.bench_run --only attn [--device cpu]
    python -m repro_torch.launch.bench_run --json-attn PATH [--device cpu]

The quantity of record is a byte count per path in the reference's two
directions, ``fwd`` and ``bwd`` (``assert_complete`` holds every path to
them and to a total that reconciles; ``bench_run --json-attn`` exits 1
otherwise), counted as ``bench_conv`` counts its own: one term per pass of
the port's program over device memory, each PyTorch op charged the bytes
of every tensor it takes and returns, each CUDA launch the rows its blocks
load and the elements they store.  0-d ops go to ``excluded_scalars``,
outside ``total``.  It models the launches; it is not a measured DRAM
count.

Materialized path: the LM's own (``models/layers._sdpa`` with
``SoftmaxLowp``, ``layers.py:187-210``), on a causal mask made outside:

=================================  =====  =================================
term                               dir.   code
=================================  =====  =================================
``q.float()``, ``k.float()``       fwd    ``layers.py:237-240``
the einsum's copy of q, ``q k^T``  fwd    ``layers.py:239-240``
``/ sqrt(hd)``, ``~mask``,         fwd    ``layers.py:240-243``
``masked_fill``
amax, subtract, ``exp_``, sum,     fwd    ``layers.py:192-195``
``div_``, the bf16 probabilities
``P v`` and the output's copy      fwd    ``layers.py:250-251``
the gradient's copy, ``dv``,       bwd    einsum backward
``dP``
``w.float()``, ``g.to(float32,     bwd    ``layers.py:200-206``
copy=True)``, mul, sum, ``sub_``,
``mul_``
``masked_fill``, ``/ sqrt(hd)``,   bwd    autograd of ``_scores``
``dk``, ``dq``, the casts back
=================================  =====  =================================

Flash path (``core/psg.PSGAttention`` on kernels 7-9):

=================================  =====  =================================
kernel 7: q rows once a block,     fwd    ``flash_attn.cu:490``, ``:565``
k and v rows per causal stage
(FQ = 128 x FK = 64 at bf16,
BQ = BK = 64 at fp32)
``delta``: ``do.float()``,         bwd    ``ops.py:146``
``o.float()``, the einsum
kernel 8: q, dO, lse, delta rows   bwd    ``flash_attn.cu:773``, ``:829``
once, k and v per stage (DQ8 =
64 x FK = 64; fp32 k twice)
``attention_psg_scales``           bwd    ``flash_attn.py:130-154``
kernel 9: its wrapper's codes of   bwd    ``flash_attn.py:671-688``,
q and dO and row norms, the six          ``flash_attn.cu:1155-1167``,
K-major planes, the zeroed int64         ``:1627-1660``
outputs, k and v rows once a
block, q, dO, rows and planes per
tile (DQ = DK = 64; fp32 BQ9 =
64 x BK9 = 32), int64 flushes
``.float()`` of the four int64    bwd    ``ops.py:156-160``
products, the two selects
the casts of dq, dk, dv            bwd    ``psg.py:160-161``
=================================  =====  =================================

Where the terms differ from the reference's formula, and why: the
reference charges one fp32 write and read per ``(S, T)`` tensor; the port's
materialized path runs more passes than that (the division by
``sqrt(hd)``, ``masked_fill`` and the subtraction each write a new fp32
``(S, T)`` tensor, and ``SoftmaxLowp``'s backward casts both bf16 tensors
to fp32).  Its flash path writes group-summed int64 products (the kernels
loop over the query heads of a kv head) where the reference charges four
fp32 products per query head, a group sum and a grouped copy.  Every tile
size is the CUDA kernel's, and each causal stage count is the kernel's own
``t_end`` (kernels 7-8) or ``iq_first`` (kernel 9).

Times: ``_shape_rows`` times the reference's two GQA shapes, forward and
the backward over q, k and v, against ``kernels/ref.flash_attention_oracle``
(the reference's comparator); ``_paper_totals`` adds ``device_ms`` of one
``PAPER_LM`` layer at batch 2 on both paths (the LM's materialized
attention against ``psg.attention``; CUDA events) and ``device_busy_ms``
(``bench_common.device_profile``), null off the card.  The same profile
holds ``flash_launches``, the grids of kernels 7-9 at the byte model's
tiles, against the grids the card launched (``launches_held``): a kernel
retiled without its model fails the record.
``profiles_discarded`` counts the profiler sessions thrown away because
their call lost device records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.launch.bench_common import (Launch, Term, check_launches,
                                             csv_row, device_label,
                                             device_profile, time_us)
from repro_torch.launch.train import _fp32_is_fp32

FP32, BF16, INT8, INT16, INT64 = 4, 2, 1, 2, 8
PROBS = BF16            # models/layers.PROBS_DTYPE

#: every path's accounting must report exactly these traffic directions
#: (plus informational extras outside ``total``)
REQUIRED_COMPONENTS = ("fwd", "bwd")
S_ = "excluded_scalars"

FQ, FK, DQ8 = 128, 64, 64      # kernels 7-8 on bf16 (flash_attn.cu:490, 773)
BQ = BK = 64                   # kernels 7-8 on fp32 (flash_attn.cu:171)
DQ = DK = 64                   # kernel 9 on bf16 (flash_attn.cu:1155)
BQ9, BK9 = 64, 32              # kernel 9 on fp32 (flash_attn.cu:173)
PLANES = 6                     # kernel 9's K-major code planes
FALLBACK_TILE = 128            # kv rows of a fallback flag (flash_attn.py)


class IncompleteAccountingError(RuntimeError):
    """An attention path's byte accounting is missing a direction."""


def assert_complete(acct: Dict[str, int], path: str) -> None:
    """Fail loudly if ``acct`` omits a traffic direction or its total
    does not reconcile with the components (bench_run --json-attn gate)."""
    missing = [c for c in REQUIRED_COMPONENTS if not acct.get(c, 0) > 0]
    if missing:
        raise IncompleteAccountingError(
            f"{path}: byte accounting incomplete: missing/zero "
            f"components {missing} (have {sorted(acct)})")
    if acct.get("total") != sum(acct[c] for c in REQUIRED_COMPONENTS):
        raise IncompleteAccountingError(
            f"{path}: total {acct.get('total')} != sum of "
            f"{REQUIRED_COMPONENTS}")


@dataclasses.dataclass(frozen=True)
class AttnShape:
    """One self-attention site: GQA geometry + operand width."""
    batch: int
    seq: int
    heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    op_bytes: int = BF16          # operand (q/k/v/do) element width
    kind: str = "lm"

    @property
    def q_elems(self) -> int:
        return self.batch * self.seq * self.heads * self.head_dim

    @property
    def kv_elems(self) -> int:
        return self.batch * self.seq * self.kv_heads * self.head_dim

    @property
    def st_elems(self) -> int:
        """(B, nh, S, T) score-tensor element count (T = S here)."""
        return self.batch * self.heads * self.seq * self.seq

    @property
    def rows_elems(self) -> int:
        """One (B, nh, S) fp32 row statistic (lse / delta)."""
        return self.batch * self.heads * self.seq

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.op_bytes == BF16 else torch.float32


def _cast(n: int, src: int, dst: int) -> int:
    """A dtype cast of ``n`` elements; none where the dtypes agree."""
    return 0 if src == dst else n * (src + dst)


# ---------------------------------------------------------------------------
# the materialized path
# ---------------------------------------------------------------------------


def materialized_terms(s: AttnShape) -> List[Term]:
    """Every pass of ``layers._sdpa``'s forward and of its backward over q,
    k and v, for ``nh > nkv > 1`` (the einsums copy q, the output, the
    gradient and dq into their product layouts, and k and v too where the
    batch is above 1)."""
    e, nq, nkv, st = s.op_bytes, s.q_elems, s.kv_elems, s.st_elems
    rows, mask = 4 * s.rows_elems, s.seq * s.seq
    f = [("q.float()", _cast(nq, e, FP32)),
         ("k.float()", _cast(nkv, e, FP32)),
         ("einsum: copy of q", 2 * FP32 * nq),
         ("q k^T", FP32 * (nq + nkv + st)),
         ("/ sqrt(hd)", 2 * FP32 * st),
         ("~mask", 2 * mask),
         ("masked_fill", 2 * FP32 * st + mask),
         ("amax", FP32 * st + rows),
         ("subtract the max", 2 * FP32 * st + rows),
         ("exp_", 2 * FP32 * st),
         ("sum", FP32 * st + rows),
         ("div_", 2 * FP32 * st + rows),
         ("probabilities to bf16", (FP32 + PROBS) * st),
         ("w.to(v.dtype)", _cast(st, PROBS, e)),
         ("P v", e * st + e * nkv + e * nq),
         ("einsum: copy of the output", 2 * e * nq)]
    if s.batch > 1:         # (b, n) batch dims: k and v permute by copy too
        f += [("einsum: copy of k", 2 * FP32 * nkv),
              ("einsum: copy of v", 2 * e * nkv)]
    b = [("einsum: copy of the gradient", 2 * e * nq),
         ("dv = P^T dO", e * st + e * nq + e * nkv),
         ("dP = dO v^T", e * nq + e * nkv + e * st),
         ("dP to bf16", _cast(st, e, PROBS)),
         ("w.float()", (PROBS + FP32) * st),
         ("g.to(float32, copy=True)", (PROBS + FP32) * st),
         ("g * w", 3 * FP32 * st),
         ("sum", FP32 * st + rows),
         ("sub_", 2 * FP32 * st + rows),
         ("mul_", 3 * FP32 * st),
         ("masked_fill", 2 * FP32 * st + mask),
         ("/ sqrt(hd)", 2 * FP32 * st),
         ("dk = dS^T q", FP32 * (nq + st + nkv)),
         ("dq = dS k", FP32 * (st + nkv + nq)),
         ("dk cast", _cast(nkv, FP32, e)),
         ("dq cast", _cast(nq, FP32, e)),
         ("einsum: copy of dq", 2 * e * nq)]
    return [Term("fwd", w, n) for w, n in f] + \
        [Term("bwd", w, n) for w, n in b]


# ---------------------------------------------------------------------------
# the flash path: kernels 7-9 as csrc/flash_attn.cu launches them
# ---------------------------------------------------------------------------


def _valid(row0: int, rows: int, length: int) -> int:
    return max(0, min(rows, length - row0))


def kernel7_bytes(s: AttnShape) -> int:
    """Kernel 7: per block (query tile, batch x head) the q rows once, k
    and v rows of every stage up to the causal ``t_end``, o and lse."""
    S, hd, e = s.seq, s.head_dim, s.op_bytes
    bq, bk = (FQ, FK) if e == BF16 else (BQ, BK)
    per_bh = 0
    for q0 in range(0, S, bq):
        t_end = min(S, q0 + bq) if s.causal else S
        kv = sum(_valid(k0, bk, S) for k0 in range(0, max(t_end, 1), bk))
        rows = _valid(q0, bq, S)
        per_bh += rows * hd * e + 2 * kv * hd * e + rows * (hd * e + FP32)
    return s.batch * s.heads * per_bh


def kernel8_bytes(s: AttnShape) -> int:
    """Kernel 8: per block q, dO, lse and delta rows once, k and v rows
    of every stage (the fp32 kernel loads k twice, transposed and not), dq
    in fp32."""
    S, hd, e = s.seq, s.head_dim, s.op_bytes
    bq, bk, k_loads = (DQ8, FK, 2) if e == BF16 else (BQ, BK, 3)
    per_bh = 0
    for q0 in range(0, S, bq):
        t_end = min(S, q0 + bq) if s.causal else S
        kv = sum(_valid(k0, bk, S) for k0 in range(0, max(t_end, 1), bk))
        rows = _valid(q0, bq, S)
        per_bh += rows * (2 * hd * e + 2 * FP32) + k_loads * kv * hd * e \
            + rows * hd * FP32
    return s.batch * s.heads * per_bh


def dkv_flush_tiles() -> tuple:
    """``flash_attn.dkv_flush_tiles`` at the PSG config's code limits."""
    from repro_torch.core.config import PSGConfig
    from repro_torch.kernels.flash_attn import dkv_flush_tiles as tiles, qlim
    c = PSGConfig()
    return tiles((qlim(c.bits_x), qlim(c.bits_x_msb), qlim(c.bits_g),
                  qlim(c.bits_g_msb)))


def kernel9_bytes(s: AttnShape) -> int:
    """Kernel 9's launches: the four int64 outputs zeroed; at bf16 the four
    pre-passes writing the six K-major code planes, then per block (kv
    tile, batch x kv head) k, v and their row norms once and, for each of
    the group's query heads and each causal query tile, the q and dO rows,
    four row values and the tile's six planes; at fp32 per block k and v
    once and per tile q, dO, their four code rows, lse and delta.  Each
    flush of an int32 partial is an int64 read-modify-write of the block's
    kv rows."""
    B, S, nh, nkv, hd, e = (s.batch, s.seq, s.heads, s.kv_heads,
                            s.head_dim, s.op_bytes)
    g = nh // nkv
    flush_full, flush_msb = dkv_flush_tiles()
    out = 4 * INT64 * B * S * nkv * hd
    if e == BF16:
        sp = -(-S // DQ) * DQ
        c = nh * hd
        out += B * S * c * (INT8 + INT8 + INT16 + INT16) + PLANES * B * c * sp
        n_q = sp // DQ
        per = 0
        for kv0 in range(0, S, DK):
            kv = _valid(kv0, DK, S)
            n_it = g * max(0, n_q - (kv0 // DQ if s.causal else 0))
            tiles = 0
            for it in range(n_it):
                q0 = ((kv0 // DQ if s.causal else 0) + it % (n_it // g)) * DQ
                rows = _valid(q0, DQ, S)
                tiles += rows * (2 * hd * BF16 + 4 * FP32) + PLANES * hd * DQ
            flushes = 2 * (n_it // flush_full) + 2 * (n_it // flush_msb) + 4
            per += kv * (2 * hd * BF16 + 2 * FP32) + tiles \
                + flushes * kv * hd * 2 * INT64
        return out + B * nkv * per
    n_q = -(-S // BQ9)
    per = 0
    for kv0 in range(0, S, BK9):
        kv = _valid(kv0, BK9, S)
        first = kv0 // BQ9 if s.causal else 0
        tiles = t_full = t_msb = flushes = 0
        for _ in range(g):
            for c0 in range(first, n_q, flush_msb):
                c1 = min(n_q, c0 + flush_msb)
                if t_msb + (c1 - c0) > flush_msb:
                    flushes += 2
                    t_msb = 0
                t_msb += c1 - c0
                for iq in range(c0, c1):
                    rows = _valid(iq * BQ9, BQ9, S)
                    tiles += rows * (2 * hd * FP32 + hd * (2 * INT8
                                                           + 2 * INT16)
                                     + 2 * FP32)
                    t_full += 1
                    if t_full == flush_full:
                        flushes += 2
                        t_full = 0
        flushes += 4
        per += 2 * kv * hd * FP32 + tiles + flushes * kv * hd * 2 * INT64
    return out + B * nkv * per


def kernel9_wrapper_terms(s: AttnShape) -> List[Term]:
    """Kernel 9's wrapper's own PyTorch ops on the card (its plain version
    takes their place on the CPU): ``operand_codes`` (q and dO to fp32,
    four code grids by division, round, clamp and cast) and, at bf16,
    ``row_norms`` (each of q, dO, k, v to fp32, squared, summed, square
    root, the transposed copy, and their concatenation)."""
    e, nq, nkv = s.op_bytes, s.q_elems, s.kv_elems
    codes = 2 * _cast(nq, e, FP32) + sum(
        (4 + 4) * nq + 2 * 8 * nq + (4 + c) * nq
        for c in (INT8, INT8, INT16, INT16))
    terms = [Term("bwd", "kernel 9 operand codes", codes, "flash_bwd_dkv"),
             Term(S_, "kernel 9 operand codes' scales", 4 * FP32,
                  "flash_bwd_dkv")]
    if e == BF16:
        norms = 0
        for n in (nq, nq, nkv, nkv):
            r = n // s.head_dim
            norms += _cast(n, e, FP32) + 2 * FP32 * n + FP32 * (n + r) \
                + 2 * FP32 * r + 2 * FP32 * r
        norms += 2 * FP32 * 2 * (s.rows_elems + s.batch * s.seq
                                 * s.kv_heads)
        terms.append(Term("bwd", "kernel 9 row norms", norms,
                          "flash_bwd_dkv"))
    return terms


def _select_bytes(s: AttnShape) -> int:
    """``psg_attention_select`` on one group-summed pair: abs and amax,
    abs again for the mask, the two dequantizing multiplies, the ``where``,
    the padding of the mask to whole 128-row tiles, its negation and two
    ``any``, the flags' cast and mean."""
    n = s.kv_elems
    pad = (-s.seq) % FALLBACK_TILE
    npad = s.batch * pad * s.kv_heads * s.head_dim
    nt = s.batch * ((s.seq + pad) // FALLBACK_TILE) * s.kv_heads
    b = (2 * FP32 * n + FP32 * n          # abs, amax
         + 2 * FP32 * n + (FP32 + 1) * n  # abs, >=
         + 2 * 2 * FP32 * n               # two multiplies
         + (1 + 2 * FP32 + FP32) * n)     # where
    if pad:
        b += npad + 2 * (n + npad)        # new_ones, cat
    b += 2 * (n + npad)                   # ~tiles
    b += (n + npad) + nt * FALLBACK_TILE  # any over hd
    b += nt * FALLBACK_TILE + nt          # any over the tile's rows
    b += nt * (1 + FP32) + nt * FP32      # float, mean
    return b


def flash_terms(s: AttnShape) -> List[Term]:
    """Every pass of ``psg.attention``'s forward and of its backward over
    q, k and v on the kernels."""
    e, nq, nkv = s.op_bytes, s.q_elems, s.kv_elems
    rows = FP32 * s.rows_elems
    kv_rows = FP32 * s.batch * s.seq * s.kv_heads
    scales = (_cast(nq, e, FP32) + _cast(nkv, e, FP32) + _cast(nq, e, FP32)
              + 2 * FP32 * nq + FP32 * nq          # q abs, amax
              + 2 * FP32 * nq + FP32 * nq          # dO abs, amax
              + 3 * FP32 * nq + FP32 * nq + rows   # dO * dO, sum
              + rows                               # amax
              + 3 * FP32 * nkv + FP32 * nkv + kv_rows + kv_rows
              + 2 * rows + rows)                   # delta abs, amax
    return ([Term(S_, "probe", 8),
             Term("fwd", "kernel 7", kernel7_bytes(s), "flash_fwd")]
            + [Term("bwd", "delta: do.float(), o.float()",
                    2 * _cast(nq, e, FP32)),
               Term("bwd", "delta: the einsum's copies, the product",
                    4 * FP32 * nq + 2 * FP32 * nq + rows),
               Term("bwd", "kernel 8", kernel8_bytes(s), "flash_bwd_dq"),
               Term("bwd", "attention_psg_scales", scales),
               Term("bwd", "kernel 9", kernel9_bytes(s), "flash_bwd_dkv")]
            + kernel9_wrapper_terms(s)
            + [Term("bwd", "products .float()", 4 * (INT64 + FP32) * nkv),
               Term("bwd", "two selects", 2 * _select_bytes(s)),
               Term("bwd", "dq, dk, dv casts",
                    _cast(nq, FP32, e) + 2 * _cast(nkv, FP32, e))]
            + [Term(S_, "scales, selects, probe", SCALAR_BYTES)])


#: 0-d traffic of the flash backward: ``attention_psg_scales``' five maxima
#: (their writes, the stack), two roots, the bound, four ``qscale`` and two
#: divisions and the stack of six (272 + 20); the four dequantizing factors
#: (16 for dv's, 24 for dk's) and per select the threshold (the max's
#: write, ``beta *``), the reads of the threshold in ``>=`` and of the
#: factors in the two multiplies, the flags' mean (2 x 28); the ratio, the
#: MAC count and the probe gradient (60)
SCALAR_BYTES = 272 + 20 + 40 + 2 * 28 + 60


def flash_launches(s: AttnShape) -> List[Launch]:
    """Kernels 7-9's launches in one flash step at ``s`` (grids), at the
    tiles that their byte terms count: ``_paper_totals`` holds them
    against the card's."""
    B, S, nh, nkv = s.batch, s.seq, s.heads, s.kv_heads
    if s.op_bytes == BF16:
        return [Launch("flash_fwd_mma_kernel", (-(-S // FQ), B * nh, 1)),
                Launch("flash_bwd_dq_mma_kernel", (-(-S // DQ8), B * nh, 1)),
                Launch("flash_bwd_dkv_mma_kernel",
                       (-(-S // DK) * B * nkv, 1, 1))]
    return [Launch("flash_fwd_kernel", (-(-S // BQ), B * nh, 1)),
            Launch("flash_bwd_dq_kernel", (-(-S // BQ), B * nh, 1)),
            Launch("flash_bwd_dkv_kernel", (-(-S // BK9), B * nkv, 1))]


def summarize(terms: List[Term]) -> Dict[str, int]:
    acct: Dict[str, int] = {"fwd": 0, "bwd": 0, "total": 0, S_: 0}
    for t in terms:
        acct[t.comp] += t.nbytes
    acct["total"] = acct["fwd"] + acct["bwd"]
    return acct


def materialized_bytes(s: AttnShape) -> Dict[str, int]:
    """Bytes the materialized path moves at one attention site."""
    return summarize(materialized_terms(s))


def flash_bytes(s: AttnShape) -> Dict[str, int]:
    """Bytes the flash path moves at one attention site."""
    return summarize(flash_terms(s))


def _ratios(b_mat: Dict[str, int], b_flash: Dict[str, int]) -> Dict:
    return {"bytes_ratio": b_mat["total"] / b_flash["total"],
            "fwd_bytes_ratio": b_mat["fwd"] / b_flash["fwd"],
            "bwd_bytes_ratio": b_mat["bwd"] / b_flash["bwd"]}


#: paper-shaped LM attention site: llama-class bf16 GQA geometry.
PAPER_LM = AttnShape(batch=8, seq=4096, heads=32, kv_heads=8, head_dim=128,
                     causal=True, op_bytes=BF16, kind="paper_lm")
TIMED_BATCH = 2         # one fp32 (S, T) tensor of PAPER_LM is 4.3 GB here


# ---------------------------------------------------------------------------
# the timed programs
# ---------------------------------------------------------------------------


def attn_inputs(s: AttnShape, dev: torch.device):
    """``(q, k, v, gy)`` in the shape's dtype from a seed of the geometry
    (numpy, so both devices see the same values)."""
    rng = np.random.default_rng([s.seq, s.heads, s.kv_heads, s.head_dim])

    def normal(*sh, scale=1.0):
        return torch.from_numpy((rng.standard_normal(sh) * scale)
                                .astype(np.float32)).to(dev, s.dtype)
    B, S = s.batch, s.seq
    return (normal(B, S, s.heads, s.head_dim),
            normal(B, S, s.kv_heads, s.head_dim),
            normal(B, S, s.kv_heads, s.head_dim),
            normal(B, S, s.heads, s.head_dim, scale=0.01))


def attn_step(s: AttnShape, path: str):
    """Forward and the gradients of ``sum(o * gy)`` over q, k and v:
    ``"flash"`` (``psg.attention`` under PSG with the flash kernels),
    ``"materialized"`` (the LM's ``layers._sdpa``, both byte models' other
    path) or ``"oracle"`` (``kernels/ref.flash_attention_oracle``)."""
    from repro_torch.core import psg
    from repro_torch.core.config import PSGConfig
    from repro_torch.kernels.ref import flash_attention_oracle
    from repro_torch.models import layers

    cfg = PSGConfig(enabled=True, fused_attention=True)
    masks: Dict[str, torch.Tensor] = {}

    def step(q, k, v, gy):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            if path == "flash":
                with psg.enable(cfg):
                    o = psg.attention(q, k, v, causal=s.causal)
            elif path == "oracle":
                o = flash_attention_oracle(q, k, v, s.causal)
            else:
                key = str(q.device)
                if key not in masks:        # made once, outside the model
                    masks[key] = layers.causal_mask(s.seq, s.seq,
                                                    device=q.device)
                o = layers._sdpa(q, k, v, masks[key])
            return torch.autograd.grad(o, (q, k, v), gy.to(o.dtype))
    return step


def _paper_totals(layers: int = 32, device=None) -> Dict:
    """Per-training-step attention-byte totals over every layer of the
    paper-shaped LM; the acceptance quantity is ``bytes_ratio`` (whole
    step, fwd + bwd, at least 3).  On the card also the device ms of one
    layer at batch ``TIMED_BATCH`` on both paths, and that layer's bytes
    over that time; null on the CPU (``device=None`` times nothing)."""
    b_mat = {c: v * layers for c, v in materialized_bytes(PAPER_LM).items()}
    b_flash = {c: v * layers for c, v in flash_bytes(PAPER_LM).items()}
    assert_complete(b_mat, "materialized/paper_totals")
    assert_complete(b_flash, "flash/paper_totals")
    timed = dataclasses.replace(PAPER_LM, batch=TIMED_BATCH)
    ms: Dict[str, Optional[float]] = {"materialized": None, "flash": None}
    busy = dict(ms)
    held: Optional[Dict[str, int]] = None
    discarded: Optional[int] = None
    dev = None if device is None else resolve_device(device)
    if dev is not None and dev.type == "cuda":
        _fp32_is_fp32()
        args = attn_inputs(timed, dev)
        discarded = 0
        for p in ms:
            ms[p] = time_us(attn_step(timed, p), *args)[0] / 1e3
            prof = device_profile(attn_step(timed, p), *args)
            busy[p], discarded = prof.busy_ms, discarded + prof.discarded
        held = check_launches(flash_launches(timed), prof.launches,
                              f"flash {timed}")
        del args
        torch.cuda.empty_cache()
    layer = {"materialized": materialized_bytes(timed)["total"],
             "flash": flash_bytes(timed)["total"]}
    return {"batch": PAPER_LM.batch, "seq": PAPER_LM.seq,
            "heads": PAPER_LM.heads, "kv_heads": PAPER_LM.kv_heads,
            "head_dim": PAPER_LM.head_dim, "layers": layers,
            "operand_dtype": "bfloat16",
            "materialized_bytes_per_step": b_mat,
            "flash_bytes_per_step": b_flash,
            **_ratios(b_mat, b_flash),
            "device_ms_batch": TIMED_BATCH,
            "device_ms": ms,
            "time_ratio": None if ms["flash"] is None
            else ms["materialized"] / ms["flash"],
            "device_busy_ms": busy,
            "busy_ratio": None if busy["flash"] is None
            else busy["materialized"] / busy["flash"],
            "launches_held": held, "profiles_discarded": discarded,
            "layer_bytes_at_timed_batch": layer,
            "implied_tb_s": {p: None if ms[p] is None else
                             layer[p] / ms[p] / 1e9 for p in ms},
            "implied_tb_s_busy": {p: None if busy[p] is None else
                                  layer[p] / busy[p] / 1e9 for p in busy}}


def _shape_rows(fast: bool, device=None) -> List[Dict]:
    """Timed forward and backward per small GQA shape, the flash path
    against the oracle, beside the byte model of the same geometry."""
    dev = resolve_device(device)
    _fp32_is_fp32()
    shapes = [AttnShape(1, 128, 4, 2, 32, kind="gqa_small"),
              AttnShape(1, 256, 4, 2, 64, kind="gqa_body")]
    if fast:
        shapes = shapes[:1]
    rows = []
    for s in shapes:
        args = attn_inputs(s, dev)
        us_mat, _ = time_us(attn_step(s, "oracle"), *args)
        us_flash, _ = time_us(attn_step(s, "flash"), *args)
        b_mat, b_flash = materialized_bytes(s), flash_bytes(s)
        assert_complete(b_mat, f"materialized/{s.kind}")
        assert_complete(b_flash, f"flash/{s.kind}")
        f32 = dataclasses.replace(s, op_bytes=FP32)
        rows.append({
            "batch": s.batch, "seq": s.seq, "heads": s.heads,
            "kv_heads": s.kv_heads, "head_dim": s.head_dim,
            "causal": s.causal, "kind": s.kind,
            "operand_dtype": str(s.dtype).replace("torch.", ""),
            "us_materialized": us_mat, "us_flash": us_flash,
            "materialized_bytes": b_mat, "flash_bytes": b_flash,
            **_ratios(b_mat, b_flash),
            "bytes_ratio_f32_operands": _ratios(
                materialized_bytes(f32), flash_bytes(f32))["bytes_ratio"]})
    return rows


def _train_proxy(fast: bool, device=None) -> Dict:
    """Executed steps per second of a short LM training A/B with
    ``fused_attention`` on and off on ``device``, with the measured PSG
    fallback ratio and saving of the flash run."""
    from repro_torch.core.config import E2TrainConfig, PSGConfig
    from repro_torch.launch.bench_common import final_loss, run_lm

    dev = resolve_device(device)
    steps = 3 if fast else 8
    out: Dict = {"steps": steps, "device": device_label(dev),
                 "note": "loop-level A/B (the first step builds the "
                         "kernels on the card); the byte counts are the "
                         "quantity of record"}
    for label, fused in (("materialized", False), ("flash", True)):
        e2 = E2TrainConfig(psg=PSGConfig(enabled=True, swa=False,
                                         fused_attention=fused))
        hist, tr, wall = run_lm(e2, steps, optimizer="psg", lr=0.05,
                                device=dev)
        out[f"{label}_steps_per_s"] = steps / wall
        out[f"{label}_final_loss"] = final_loss(hist, k=2)
        if fused:
            fb = tr.measured_psg_fallback()
            out["psg_fallback_ratio_measured"] = (
                None if fb is None else float(fb))
            out["comp_saving_measured"] = tr.energy_report(
                steps=steps).computational_savings_measured
    return out


def attn_json(fast: bool = True, device=None) -> dict:
    """The attention record.  Raises :class:`IncompleteAccountingError` if
    any path omits a traffic direction (``bench_run --json-attn`` exits
    1)."""
    dev = resolve_device(device)
    return {"device": device_label(dev),
            "paper_lm_s4096": _paper_totals(device=dev),
            "shapes": _shape_rows(fast, dev),
            "train_proxy": _train_proxy(fast, dev)}


def run(fast: bool = True, device=None):
    """CSV rows for ``bench_run``."""
    dev = resolve_device(device)
    return rows(_paper_totals(device=dev), _shape_rows(fast, dev))


def rows(totals: Dict, shape_rows: List[Dict]):
    """The CSV rows of a record's ``paper_lm_s4096`` and ``shapes``."""
    ms = totals["device_ms"]
    yield csv_row(
        "attn/paper_lm_s4096",
        0.0 if ms["flash"] is None else 1e3 * ms["flash"],
        f"bytes_ratio={totals['bytes_ratio']:.2f};"
        f"fwd_bytes_ratio={totals['fwd_bytes_ratio']:.2f};"
        f"bwd_bytes_ratio={totals['bwd_bytes_ratio']:.2f};"
        f"materialized_GB={totals['materialized_bytes_per_step']['total']/1e9:.2f};"
        f"flash_GB={totals['flash_bytes_per_step']['total']/1e9:.2f}"
        + ("" if ms["flash"] is None else
           f";materialized_ms={ms['materialized']:.3f};"
           f"flash_ms={ms['flash']:.3f}"))
    for r in shape_rows:
        yield csv_row(
            f"attn/{r['kind']}/{r['batch']}x{r['seq']}x{r['heads']}-"
            f"{r['kv_heads']}h{r['head_dim']}",
            r["us_flash"],
            f"materialized_us={r['us_materialized']:.1f};"
            f"bytes_ratio={r['bytes_ratio']:.2f};"
            f"bwd_bytes_ratio={r['bwd_bytes_ratio']:.2f}")
