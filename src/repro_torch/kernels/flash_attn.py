"""Flash attention with the PSG dk/dv backward: three kernels.

Three CUDA kernels (``csrc/flash_attn.cu``), each behind a wrapper with a
plain PyTorch version beside it.  A wrapper given CPU tensors computes the
plain version; given CUDA tensors it launches its kernel or raises.  Each
launch adds one to ``LAUNCHES[<wrapper name>]``.

Layouts are the JAX package's: q and dO ``(B, S, nh, hd)``, k and v
``(B, T, nkv, hd)`` with ``nh % nkv == 0`` (query head ``h`` reads kv head
``h // (nh // nkv)``), lse and delta ``(B, nh, S)`` fp32.

=============  =====================================================
wrapper        replaces (JAX package, ``kernels/flash_attn.py``)
=============  =====================================================
flash_fwd      ``flash_attention`` / ``_flash_kernel``
flash_bwd_dq   ``flash_bwd_dq_pallas`` / ``_flash_bwd_dq_kernel``
flash_bwd_dkv  ``flash_bwd_dkv_pallas`` / ``_flash_bwd_dkv_kernel``
=============  =====================================================

No ``(S, T)`` tensor reaches device memory in either direction: the
forward keeps a running row max and row sum and emits the logsumexp; the
backward recomputes each probability tile from it.

``flash_fwd`` picks its kernel by dtype.  bf16 operands run on the bf16
tensor cores: ``q k^T`` as bf16 MMAs with fp32 sums (exact products, only
the order of the sum differs), the online softmax in registers in JAX's
order, and ``P v`` with P split into ``p_hi = bf16(p)`` and ``p_lo =
bf16(p - p_hi)``, two bf16 MMAs that keep about 16 bits of the fp32 P the
reference multiplies (``|p - p_hi - p_lo| <= 2**-16 p``), fed by a
two-stage ``cp.async`` ring of 64-key tiles.  :func:`flash_attention_split_p`
is that arithmetic in plain PyTorch.  fp32 operands run on the CUDA cores
in fp32, as no LM path does (its activations are bf16).

``flash_bwd_dq`` picks its kernel by dtype too.  bf16 operands run on the
bf16 tensor cores: ``q k^T`` and ``dO v^T`` as bf16 MMAs (one fresh fp32
sum a 16-wide step, added round-to-nearest), P and dS in registers in JAX's
order, and ``dq = dS k`` with dS split into three bf16 parts (hi, mid, lo:
about 24 bits, as fp32 keeps), three MMAs against each k fragment, each
64-key tile's sum added into dq round-to-nearest.  Two parts would not do:
every row of dS sums to about zero, so where the keys share a common
component (:func:`dq_cancel_inputs`) dq cancels and a 2**-16 error in dS
passes the contract's ``1e-5 * max|dq|``.  :func:`flash_bwd_dq_split_plain`
is that arithmetic in plain PyTorch.  fp32 operands run on the CUDA cores.

``flash_bwd_dkv`` is the PSG kernel: it quantizes P and dS in-tile onto
their grids (:func:`codes_tile`, the JAX package's operations) and sums the
four code products of ``dv = P^T dO`` and ``dk = dS^T q`` (predictor and
full) in integers, which is exact.  It too picks its kernel by dtype.
bf16 operands run on the tensor cores: ``K Q^T`` and ``V dO^T`` as bf16
MMAs, and the code products as int8 MMAs over 64-row query tiles with the
16-bit operand (dO, or dS) in byte planes, each product's ``256 hi + lo``
folded into one wrapping int32 sum and added into int64 every
:func:`dkv_flush_tiles` tiles (:func:`flash_bwd_dkv_mma_plain` is that
arithmetic in plain PyTorch).  The codes are those of the sequential fp32
scores of the CUDA-core kernel: a pair whose code could differ within the
MMA scores' error bound (:func:`row_norms`) has its scores recomputed in
that order.  The codes of q and dO reach the kernel as K-major byte
planes, written by a pre-pass into scratch the wrapper allocates.  fp32
operands keep the CUDA-core kernel (``__dp2a`` integer products).  Unlike
the TPU kernel, which emits one product per *query* head, both kernels loop
over the query heads of each kv head and emit the group-summed products,
as the plain version does.  The Eq. (2) select
(:func:`psg_attention_select`) runs outside, on those products, with the
fallback tiles at the TPU kernel's ``128``-row kv tiling whatever the CUDA
tiling is.

The plain versions materialize the ``(S, T)`` tiles one (batch, head) at a
time; ``flash_bwd_dkv_plain`` multiplies the codes as float64, which is
exact below 2**53, so its integer products are those of the kernel
wherever both make the same codes.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.quant import qscale
from repro_torch.distributed import sharding
from repro_torch.kernels.conv import _call, _check, _on_cuda, _stream

NEG_INF = -1e30
FALLBACK_TILE = 128     # kv rows of one fallback tile (the TPU kernel's bk)
HEAD_DIMS = (16, 32, 64, 96, 128)   # the head dims the CUDA kernels are built for
FWD_BLOCK_K = 64        # kv rows a stage of the bf16 forward kernel
DKV_TILE = 64           # query rows a tile and kv rows a block of kernel 9
DKV_PLANES = 6          # K-major code planes the bf16 kernel 9 reads

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# tile math (copies of the JAX package's helpers)
# ---------------------------------------------------------------------------


def qlim(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1.0


def softmax_scale(hd: int) -> float:
    """``float32(1 / sqrt(hd))``, the score scale of both packages."""
    return float(np.float32(1.0 / math.sqrt(hd)))


def _f32(value: float, device) -> torch.Tensor:
    """A 0-d fp32 tensor: divide by it, never by a Python number, which
    PyTorch turns into a multiply by the reciprocal on a CUDA tensor."""
    return torch.full((), value, dtype=torch.float32, device=device)


def codes_tile(x: torch.Tensor, s, lim: float) -> torch.Tensor:
    """Integer codes of ``x`` on the grid with scale ``s`` (fp32 values):
    ``clip(round(x / s), -lim, lim)``, the division in fp32."""
    if not torch.is_tensor(s):
        s = _f32(s, x.device)
    return torch.clamp(torch.round(x / s), -lim, lim)


def attention_psg_scales(q: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                         delta: torch.Tensor, *, bits_x: int,
                         bits_x_msb: int, bits_g: int,
                         bits_g_msb: int) -> torch.Tensor:
    """The six grid scales of the dk/dv kernel, ``[s_q, s_q_msb, s_do,
    s_do_msb, s_ds, s_ds_msb]`` fp32: per-tensor grids for q and dO, and for
    dS (never materialized) the analytic bound ``|dS| <= (max_s ||dO_s|| *
    max_t ||v_t|| + max|delta|) / sqrt(hd)``.  Under a mesh each of the
    five maxima is the global batch's (one MAX all-reduce)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    do32, v32 = do.float(), v.float()
    maxima = torch.stack([
        q.float().abs().amax(), do32.abs().amax(),
        torch.amax(torch.sum(do32 * do32, dim=-1)),
        torch.amax(torch.sum(v32 * v32, dim=-1)), delta.abs().amax()])
    if sharding.data_group() is not None:
        maxima = sharding.global_max(maxima)
    aq, ado, ss_do, ss_v, adelta = maxima.unbind()
    rn_do, rn_v = torch.sqrt(ss_do), torch.sqrt(ss_v)
    bound = torch.clamp_min(scale * (rn_do * rn_v + adelta), 1e-12)
    return torch.stack([
        qscale(q, bits_x, aq), qscale(q, bits_x_msb, aq),
        qscale(do, bits_g, ado), qscale(do, bits_g_msb, ado),
        bound / _f32(qlim(bits_g), q.device),
        bound / _f32(qlim(bits_g_msb), q.device)]).float()


def psg_attention_select(msb: torch.Tensor, full: torch.Tensor, deq_msb,
                         deq_full, beta: float, tile_t: int = FALLBACK_TILE
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2) on a group-summed code-product pair ``(B, T, nkv, hd)`` fp32:
    the dequantized MSB product where ``|g_msb| >= beta * max|g_msb|``, the
    dequantized full product elsewhere.  Returns ``(values, fraction of
    (tile_t x hd) kv tiles holding any fallback element)``; a partial last
    tile is padded with confident entries.  Under a mesh ``max|g_msb|``
    and the fraction are the global batch's."""
    tau = beta * sharding.global_max(msb.abs().amax())
    conf = msb.abs() >= tau
    vals = torch.where(conf, msb * deq_msb, full * deq_full)
    B, T, nkv, hd = conf.shape
    pad = (-T) % tile_t
    if pad:
        conf = torch.cat([conf, conf.new_ones((B, pad, nkv, hd))], dim=1)
    tiles = conf.reshape(B, (T + pad) // tile_t, tile_t, nkv, hd)
    need_full = (~tiles).any(dim=4).any(dim=2)
    return vals, sharding.global_mean(need_full.float())


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _dims(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, ...]:
    B, S, nh, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    return B, S, T, nh, nkv, nh // nkv, hd


def _valid(S: int, T: int, causal: bool, device) -> torch.Tensor:
    """(S, T) bool: key j is visible to query i."""
    valid = torch.ones(S, T, dtype=torch.bool, device=device)
    return valid.tril() if causal else valid


def _head(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    return x[b, :, h].float()


def _p_tile(q, k, lse, valid, scale):
    """``exp(q k^T * scale - lse)`` with invalid entries exactly zero."""
    s = (q @ k.T) * scale
    return torch.where(valid, torch.exp(s - lse[:, None]),
                       torch.zeros((), device=s.device))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o in q.dtype, lse (B, nh, S) fp32)`` by a materialized softmax in
    fp32: masked scores at -1e30, ``o = (P v) / max(l, 1e-30)``, ``lse = m +
    log(max(l, 1e-30))``."""
    B, S, T, nh, nkv, g, hd = _dims(q, k)
    scale = softmax_scale(hd)
    valid = _valid(S, T, causal, q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, S), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(nh):
            s = (_head(q, b, h) @ _head(k, b, h // g).T) * scale
            s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
            m = s.amax(dim=1, keepdim=True)
            p = torch.exp(s - m)
            lsum = torch.clamp_min(p.sum(dim=1, keepdim=True), 1e-30)
            o[b, :, h] = ((p @ _head(v, b, h // g)) / lsum).to(q.dtype)
            lse[b, h] = (m + torch.log(lsum))[:, 0]
    return o, lse


def flash_attention_split_p(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            block_k: int = FWD_BLOCK_K
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 forward kernel's arithmetic in plain PyTorch: the online
    softmax over ``block_k``-key tiles in JAX's order, and each tile's fp32
    P rounded to ``p_hi + p_lo`` (two bf16) before the fp32 products with
    v.  Returns ``(o in q.dtype, lse (B, nh, S) fp32)``; for the tests, not
    on any path."""
    B, S, T, nh, nkv, g, hd = _dims(q, k)
    scale = softmax_scale(hd)
    valid = _valid(S, T, causal, q.device)
    neg = torch.full((), NEG_INF, device=q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, S), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(nh):
            vb = _head(v, b, h // g)
            s_all = torch.where(
                valid, (_head(q, b, h) @ _head(k, b, h // g).T) * scale, neg)
            m = torch.full((S,), NEG_INF, device=q.device)
            lsum = torch.zeros(S, device=q.device)
            acc = torch.zeros(S, hd, device=q.device)
            for k0 in range(0, T, block_k):
                s = s_all[:, k0:k0 + block_k]
                m_new = torch.maximum(m, s.amax(dim=1))
                p = torch.exp(s - m_new[:, None])
                alpha = torch.exp(m - m_new)
                lsum = lsum * alpha + p.sum(dim=1)
                p_hi = p.to(torch.bfloat16).float()
                p_lo = (p - p_hi).to(torch.bfloat16).float()
                vt = vb[k0:k0 + block_k]
                acc = acc * alpha[:, None] + (p_hi @ vt + p_lo @ vt)
                m = m_new
            lc = torch.clamp_min(lsum, 1e-30)
            o[b, :, h] = (acc / lc[:, None]).to(q.dtype)
            lse[b, h] = m + torch.log(lc)
    return o, lse


def split_p_adversarial_v(q: torch.Tensor, k: torch.Tensor, *,
                          causal: bool = True,
                          block_k: int = FWD_BLOCK_K) -> torch.Tensor:
    """v ``(B, T, nkv, hd)`` in q's dtype, all entries +-1, built against
    the bf16 forward kernel's split P: column d of kv head n takes the
    signs of ``r = p - (p_hi + p_lo)`` of one target query row (head ``n g
    + d % g``, row ``S - 1 - d // g``, with p as the kernel forms it, tile
    by tile against the running max), so that the rounding terms of that
    row all add while its o, a sum of p with those signs, cancels towards
    ``sqrt(sum p^2) / l``, small against ``sum p |v| / l = 1``.  For the
    tests, not on any path."""
    B, S, T, nh, nkv, g, hd = _dims(q, k)
    scale = softmax_scale(hd)
    gen = torch.Generator(device=q.device).manual_seed(0)
    v = torch.randint(0, 2, (B, T, nkv, hd), device=q.device,
                      generator=gen).float() * 2 - 1
    for b in range(B):
        for n in range(nkv):
            for d in range(hd):
                h, i = n * g + d % g, S - 1 - d // g
                if i < 0:
                    continue
                t = T if not causal else min(T, i + 1 + T - S)
                s_row = (_head(q, b, h)[i] @ _head(k, b, n)[:t].T) * scale
                tiles = torch.arange(t, device=q.device) // block_k
                tmax = torch.full((int(tiles[-1]) + 1,), NEG_INF,
                                  device=q.device).scatter_reduce(
                    0, tiles, s_row, "amax")
                m_run = torch.cummax(tmax, 0).values[tiles]
                p = torch.exp(s_row - m_run)
                p_hi = p.to(torch.bfloat16).float()
                r = p - p_hi - (p - p_hi).to(torch.bfloat16).float()
                v[b, :t, n, d] = torch.where(r < 0, -1.0, 1.0)
    return v.to(q.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True
                       ) -> torch.Tensor:
    """dq ``(B, S, nh, hd)`` fp32: ``P = exp(s - lse)``, ``dS = P (dP -
    delta) scale``, ``dq = dS k``."""
    B, S, T, nh, nkv, g, hd = _dims(q, k)
    scale = softmax_scale(hd)
    valid = _valid(S, T, causal, q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(nh):
            kb = _head(k, b, h // g)
            p = _p_tile(_head(q, b, h), kb, lse[b, h], valid, scale)
            dp = _head(do, b, h) @ _head(v, b, h // g).T
            ds = p * (dp - delta[b, h][:, None]) * scale
            dq[b, :, h] = ds @ kb
    return dq


def split_bf16(x: torch.Tensor, terms: int) -> Tuple[torch.Tensor, ...]:
    """``x`` (fp32) as ``terms`` bf16 parts, each the bf16 rounding of what
    the parts before it left (the subtractions are exact in fp32), as fp32
    tensors: two parts keep about 16 bits of x, three about 24."""
    parts, rest = [], x
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return tuple(parts)


def flash_bwd_dq_split_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                             terms: int = 3) -> torch.Tensor:
    """The bf16 kernel 8's arithmetic in plain PyTorch: P and dS in fp32 in
    JAX's order (:func:`flash_bwd_dq_plain`), dS split into ``terms`` bf16
    parts (:func:`split_bf16`; the kernel takes three), ``dq = sum_i part_i
    k`` with fp32 products and sums.  For the tests, not on any path."""
    B, S, T, nh, nkv, g, hd = _dims(q, k)
    scale = softmax_scale(hd)
    valid = _valid(S, T, causal, q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(nh):
            kb = _head(k, b, h // g)
            p = _p_tile(_head(q, b, h), kb, lse[b, h], valid, scale)
            dp = _head(do, b, h) @ _head(v, b, h // g).T
            ds = p * (dp - delta[b, h][:, None]) * scale
            dq[b, :, h] = sum(part @ kb for part in split_bf16(ds, terms))
    return dq


def dq_cancel_inputs(B: int, S: int, nh: int, nkv: int, hd: int, *,
                     seed: int = 0, common: float = 8.0,
                     q_scale: float = 0.125, dtype=torch.bfloat16,
                     device=None) -> Tuple[torch.Tensor, ...]:
    """``(q, k, v, dO)`` on which dq cancels: the keys of each (batch, kv
    head) share a common component ``c`` of ``common`` times their spread
    (``k = common sqrt(hd) c + eps``, ``|c| = 1``, eps standard normal).
    Every row of dS sums to about zero, so ``c sum_j dS_j`` drops out of dq
    while an error in dS of relative size r leaves about ``common sqrt(hd)
    r |dS|`` in it.  q (``q_scale`` times a standard normal, a diffuse
    softmax) has its component along its kv head's c removed, so the scores
    and their rounding stay those of inputs without c.  From a numpy seed;
    for the tests and the card checks, not on any path."""
    r = np.random.RandomState(seed)
    g = nh // nkv
    q = r.randn(B, S, nh, hd) * q_scale
    c = r.randn(B, 1, nkv, hd)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    cq = np.repeat(c, g, axis=2)
    q -= (q * cq).sum(-1, keepdims=True) * cq
    k = common * math.sqrt(hd) * c + r.randn(B, S, nkv, hd)
    v = r.randn(B, S, nkv, hd)
    do = r.randn(B, S, nh, hd) * 0.1
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                           dtype=dtype)
                 for a in (q, k, v, do))


def check_lims(lims) -> None:
    """Raise unless the codes fit the CUDA kernel's int8/int16 operands.
    The kernel sums every product in int32 over at most ``(2**31 - 1) //
    max(lim_x * lim_g, lim_x_msb * lim_g_msb)`` query rows and then in
    int64, so any ``S * g`` is exact."""
    lim_x, lim_xm, lim_g, lim_gm = (int(v) for v in lims)
    if max(lim_x, lim_xm) > 127 or max(lim_g, lim_gm) > 32767 \
            or min(lim_x, lim_xm, lim_g, lim_gm) < 1:
        raise ValueError(f"code limits {lims} outside 1..int8 / int16")


def operand_codes(q, do, scales, lims):
    """The codes of q (int8) and dO (int16) on their predictor and full
    grids: ``(q_msb, q_full, do_msb, do_full)``."""
    lim_x, lim_xm, lim_g, lim_gm = lims
    qf, dof = q.float(), do.float()
    return (codes_tile(qf, scales[1], lim_xm).to(torch.int8),
            codes_tile(qf, scales[0], lim_x).to(torch.int8),
            codes_tile(dof, scales[3], lim_gm).to(torch.int16),
            codes_tile(dof, scales[2], lim_g).to(torch.int16))


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales, *, lims,
                        causal: bool = True):
    """The group-summed PSG code products of ``dv = P^T dO`` and ``dk =
    dS^T q``: ``(dv_msb, dv_full, dk_msb, dk_full)``, all int64,
    each ``(B, T, nkv, hd)`` in code units.  ``scales`` is the (6,) vector of
    :func:`attention_psg_scales`, ``lims`` the code limits ``(lim_x,
    lim_x_msb, lim_g, lim_g_msb)``."""
    B, S, T, nh, nkv, g, hd = _dims(q, k)
    scale = softmax_scale(hd)
    lim_x, lim_xm, lim_g, lim_gm = lims
    s_pm, s_pf = _f32(1.0 / lim_xm, q.device), _f32(1.0 / lim_x, q.device)
    s_ds, s_dsm = scales[4], scales[5]
    qm, qf, dom, dof = operand_codes(q, do, scales, lims)
    valid = _valid(S, T, causal, q.device)
    outs = [torch.zeros((B, T, nkv, hd), dtype=torch.float64,
                        device=q.device) for _ in range(4)]
    for b in range(B):
        for h in range(nh):
            kv = h // g
            p = _p_tile(_head(q, b, h), _head(k, b, kv), lse[b, h], valid,
                        scale)
            dp = _head(do, b, h) @ _head(v, b, kv).T
            ds = p * (dp - delta[b, h][:, None]) * scale
            pairs = ((codes_tile(p, s_pm, lim_xm), dom[b, :, h]),
                     (codes_tile(p, s_pf, lim_x), dof[b, :, h]),
                     (codes_tile(ds, s_dsm, lim_gm), qm[b, :, h]),
                     (codes_tile(ds, s_ds, lim_g), qf[b, :, h]))
            for out, (a, c) in zip(outs, pairs):
                out[b, :, kv] += a.double().T @ c.double()
    dv_m, dv_f, dk_m, dk_f = outs
    return tuple(t.to(torch.int64) for t in (dv_m, dv_f, dk_m, dk_f))


def dkv_flush_tiles(lims) -> Tuple[int, int]:
    """Query tiles of ``DKV_TILE`` rows over which kernel 9 sums its full
    products, and its predictor products, in int32 before it adds them into
    int64: as many as keep ``rows * lim_x * lim_g`` (and ``rows * lim_x_msb
    * lim_g_msb``) within int32 (8 and 9380 tiles at 8 x 16 and 4 x 10
    bits)."""
    lim_x, lim_xm, lim_g, lim_gm = (int(v) for v in lims)
    return ((2 ** 31 - 1) // (lim_x * lim_g) // DKV_TILE,
            (2 ** 31 - 1) // (lim_xm * lim_gm) // DKV_TILE)


def row_norms(q, do, k, v) -> torch.Tensor:
    """The fp32 row norms ``|q|, |dO|`` (B, nh, S) and ``|k|, |v|`` (B, nkv,
    T), flat, one after the other: the bf16 kernel 9 bounds its MMA scores'
    error by them (``|s - exact| <= 2**-17 |q| |k|``)."""
    return torch.cat([t.float().square().sum(-1).sqrt().transpose(1, 2)
                      .reshape(-1) for t in (q, do, k, v)])


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced into int32's range, as int32 sums wrap."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _plane_product(a: torch.Tensor, c: torch.Tensor, a_split: bool,
                   acc: torch.Tensor) -> torch.Tensor:
    """``acc + a^T c`` over one query tile in 32-row k-chunks as the int8
    MMAs sum it, in wrapping int32: the 16-bit operand (``a`` when
    ``a_split``, else ``c``) split into byte planes, the low plane's product
    added first, then 256 times the high plane's."""
    for r0 in range(0, a.shape[0], 32):
        ak, ck = a[r0:r0 + 32], c[r0:r0 + 32]
        hi, lo = (ak >> 8, ak & 0xFF) if a_split else (ck >> 8, ck & 0xFF)
        lo_p = _imm(lo.T, ck) if a_split else _imm(ak.T, lo)
        hi_p = _imm(hi.T, ck) if a_split else _imm(ak.T, hi)
        acc = _wrap32(_wrap32(acc + lo_p) + 256 * hi_p)
    return acc


def _imm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer matrix product, through float64 (exact below 2**53; CUDA has
    no int64 matmul)."""
    return (a.double() @ b.double()).long()


def flash_bwd_dkv_mma_plain(q, k, v, do, lse, delta, scales, *, lims,
                            causal: bool = True):
    """The bf16 kernel 9's arithmetic in plain PyTorch, on its tile
    schedule: per (batch, kv head) and ``DKV_TILE``-row kv block, over the
    g query heads and their ``DKV_TILE``-row query tiles from the diagonal
    on, ``S^T = K Q^T`` and ``dP^T = V dO^T`` in fp32, P and dS in JAX's
    order and their codes, then the four code products with the 16-bit
    operand in byte planes (:func:`_plane_product`), each summed in
    wrapping int32 and added into int64 every :func:`dkv_flush_tiles`
    tiles.  Raises unless every int32 sum it adds equals the exact one.
    Returns what :func:`flash_bwd_dkv_plain` returns; for the tests, not
    on any path."""
    B, S, T, nh, nkv, g, hd = _dims(q, k)
    scale = softmax_scale(hd)
    lim_x, lim_xm, lim_g, lim_gm = lims
    s_pm, s_pf = _f32(1.0 / lim_xm, q.device), _f32(1.0 / lim_x, q.device)
    s_ds, s_dsm = scales[4], scales[5]
    qm, qf, dom, dof = (c.long() for c in operand_codes(q, do, scales, lims))
    every = dkv_flush_tiles(lims)          # full, msb
    tile = DKV_TILE
    outs = [torch.zeros((B, T, nkv, hd), dtype=torch.int64, device=q.device)
            for _ in range(4)]
    for b in range(B):
        for kvh in range(nkv):
            for kv0 in range(0, T, tile):
                kt = _head(k, b, kvh)[kv0:kv0 + tile]
                vt = _head(v, b, kvh)[kv0:kv0 + tile]
                kj = torch.arange(kv0, kv0 + kt.shape[0], device=q.device)
                acc = [torch.zeros((kt.shape[0], hd), dtype=torch.int64,
                                   device=q.device) for _ in range(4)]
                exact = [a.clone() for a in acc]
                count = [0, 0]             # tiles since the last flush
                for h in range(kvh * g, kvh * g + g):
                    for q0 in range(kv0 // tile * tile if causal else 0, S,
                                    tile):
                        qr = slice(q0, q0 + tile)
                        qi = torch.arange(q0, min(S, q0 + tile),
                                          device=q.device)
                        s_t = kt @ _head(q, b, h)[qr].T
                        dp_t = vt @ _head(do, b, h)[qr].T
                        valid = kj[:, None] <= qi[None, :] if causal \
                            else torch.ones_like(s_t, dtype=torch.bool)
                        p = torch.where(valid, torch.exp(
                            s_t * scale - lse[b, h, qr][None, :]),
                            torch.zeros((), device=q.device))
                        ds = p * (dp_t - delta[b, h, qr][None, :]) * scale
                        pairs = ((codes_tile(p, s_pm, lim_xm).long().T,
                                  dom[b, qr, h], False),
                                 (codes_tile(p, s_pf, lim_x).long().T,
                                  dof[b, qr, h], False),
                                 (codes_tile(ds, s_dsm, lim_gm).long().T,
                                  qm[b, qr, h], True),
                                 (codes_tile(ds, s_ds, lim_g).long().T,
                                  qf[b, qr, h], True))
                        for i, (a, c, split) in enumerate(pairs):
                            acc[i] = _plane_product(a, c, split, acc[i])
                            exact[i] += _imm(a.T, c)
                        for kind, prods in ((0, (1, 3)), (1, (0, 2))):
                            count[kind] += 1
                            if count[kind] == every[kind]:
                                _flush(outs, acc, exact, prods, b, kv0, kvh)
                                count[kind] = 0
                _flush(outs, acc, exact, range(4), b, kv0, kvh)
    return tuple(outs)


def _flush(outs, acc, exact, prods, b, kv0, kvh) -> None:
    for i in prods:
        if not torch.equal(acc[i], exact[i]):
            raise OverflowError("an int32 sum of kernel 9 left int32")
        outs[i][b, kv0:kv0 + acc[i].shape[0], kvh] += acc[i]
        acc[i].zero_()
        exact[i].zero_()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("flash_attn")
    lib.flash_fwd.argtypes = [_P] * 5 + [_I] * 8 + [_P]
    lib.flash_bwd_dq.argtypes = [_P] * 7 + [_I] * 8 + [_P]
    lib.flash_bwd_dkv.argtypes = [_P] * 17 + [_I] * 8 + [_F] * 2 \
        + [_I] * 4 + [_P]
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


def _check_qkv(q, k, v) -> Tuple[int, ...]:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    _check(q, "q", q.dtype, 4)
    _check(k, "k", q.dtype, 4)
    _check(v, "v", q.dtype, 4)
    B, S, T, nh, nkv, g, hd = _dims(q, k)
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape \
            or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: not (B, S, nh, hd) and (B, T, "
                         "nkv, hd) with nh % nkv == 0")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    _check_aligned(q=q, k=k, v=v)
    return B, S, T, nh, nkv, g, hd


def _check_aligned(**ts: torch.Tensor) -> None:
    """The kernels read rows in 16-byte vectors."""
    for name, t in ts.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _check_rows(q, do, lse, delta) -> None:
    B, S, nh, _ = q.shape
    _check(do, "do", q.dtype, 4)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    _check_aligned(do=do)
    for name, t in (("lse", lse), ("delta", delta)):
        _check(t, name, torch.float32, 3)
        if t.shape != (B, nh, S):
            raise ValueError(f"{name} {tuple(t.shape)} != {(B, nh, S)}")


def _geo(B, S, T, nh, nkv, hd, causal):
    return [B, S, T, nh, nkv, hd, int(causal)]


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7: ``(o (B, S, nh, hd) in q.dtype, lse (B, nh, S) fp32)``.
    On the card bf16 operands run the tensor-core kernel (P split into two
    bf16 parts, :func:`flash_attention_split_p`) and fp32 operands the
    CUDA-core kernel; the dtype picks, never a failure."""
    if not _on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal)
    B, S, T, nh, nkv, g, hd = _check_qkv(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, nh, S), device=q.device, dtype=torch.float32)
    _call(_lib().flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), lse.data_ptr(), *_geo(B, S, T, nh, nkv, hd, causal),
          int(q.dtype == torch.bfloat16), _stream(q))
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True
                 ) -> torch.Tensor:
    """Kernel 8: dq ``(B, S, nh, hd)`` fp32, recomputed from lse.  On the
    card bf16 operands run the tensor-core kernel (dS split into three bf16
    parts, :func:`flash_bwd_dq_split_plain`) and fp32 operands the
    CUDA-core kernel; the dtype picks, never a failure."""
    if not _on_cuda(q, k, v, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal)
    B, S, T, nh, nkv, g, hd = _check_qkv(q, k, v)
    _check_rows(q, do, lse, delta)
    dq = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    _call(_lib().flash_bwd_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          *_geo(B, S, T, nh, nkv, hd, causal),
          int(q.dtype == torch.bfloat16), _stream(q))
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scales, *, lims,
                  causal: bool = True):
    """Kernel 9: the group-summed PSG code products ``(dv_msb, dv_full,
    dk_msb, dk_full)``, int64, each ``(B, T, nkv, hd)``
    (see :func:`flash_bwd_dkv_plain`).  The codes of q and dO are built here
    in PyTorch; those of P and dS inside the kernel."""
    if not _on_cuda(q, k, v, do, lse, delta, scales):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales,
                                   lims=lims, causal=causal)
    B, S, T, nh, nkv, g, hd = _check_qkv(q, k, v)
    _check_rows(q, do, lse, delta)
    _check(scales, "scales", torch.float32, 1)
    if scales.shape != (6,):
        raise ValueError(f"scales {tuple(scales.shape)} != (6,)")
    check_lims(lims)
    qm, qf, dom, dof = operand_codes(q, do, scales, lims)
    dev = q.device
    bf16 = q.dtype == torch.bfloat16
    outs = [torch.empty((B, T, nkv, hd), device=dev, dtype=torch.int64)
            for _ in range(4)]
    # the bf16 kernel's K-major code planes of q and dO, and the row norms
    # that bound its MMA scores' error
    planes = norms = None
    if bf16:
        s_pad = -(-S // DKV_TILE) * DKV_TILE
        planes = torch.empty((DKV_PLANES, B, nh * hd, s_pad), device=dev,
                             dtype=torch.uint8)
        norms = row_norms(q, do, k, v)
    lim_x, lim_xm, lim_g, lim_gm = (int(x) for x in lims)
    _call(_lib().flash_bwd_dkv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), scales.data_ptr(),
          qm.data_ptr(), qf.data_ptr(), dom.data_ptr(), dof.data_ptr(),
          norms.data_ptr() if bf16 else 0, planes.data_ptr() if bf16 else 0,
          *(o.data_ptr() for o in outs), *_geo(B, S, T, nh, nkv, hd, causal),
          int(bf16),
          float(np.float32(1.0 / lim_xm)), float(np.float32(1.0 / lim_x)),
          lim_x, lim_xm, lim_g, lim_gm, _stream(q))
    LAUNCHES["flash_bwd_dkv"] += 1
    return tuple(outs)
