"""Transformer layers: norms, rotary embedding, GQA attention (causal,
or unmasked for the encoder), cross-attention, and the (gated) MLP.

The counterpart of the JAX package's ``models/layers.py`` for training.
Parameters are ``nn.Parameter``s in ``param_dtype`` (fp32 unless a config
says otherwise) in the JAX layouts (``wq`` ``(d, nh, hd)``, ``wo`` ``(nh,
hd, d)``, MLP weights ``(in, out)``) and are cast to the activation dtype
inside each call, so a JAX tree loads as it is (``repro_torch.convert``).
Every weight matmul but the cross-attention's goes through
``core/psg.matmul``/``einsum``, so under an active PSG config it runs the
PSG matmul kernels.  Causal attention takes one of three paths, chosen as
the JAX package chooses (:func:`attention_path`): under a PSG config with
the flash kernels on and no sliding window, the flash kernels with the PSG
dk/dv backward (``core/psg.attention``), which keep every ``(S, T)`` tile
out of device memory; otherwise the softmax with scores in fp32 and
probabilities in bf16 (:class:`SoftmaxLowp`), materialized whole, or one
512-query chunk at a time (:func:`_sdpa_qchunked`) above 8192 tokens and,
when asked (the eval forward), from 1024.  The encoder's unmasked
attention and the cross-attention are always materialized.

Serving (the JAX package's KV-cache functions): ``attention_fwd(...,
return_kv=True)`` hands a prefill's RoPE'd keys and values to
:func:`fill_kv_cache`; :func:`attention_decode` runs one token against the
cache, a ring of ``min(max_len, window)`` slots under a sliding window,
writing its key and value in place.  Decode attention is the materialized
softmax, as in the JAX package, which has no decode kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import psg
from repro_torch.core.config import ModelConfig, fused_attention_active

ATTN_Q_CHUNK = 512               # queries per chunk of the chunked path
ATTN_CHUNK_THRESHOLD = 8192     # chunk the queries above this many tokens


def dense_init(shape, generator: torch.Generator, scale: float = 1.0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fan-in truncated-normal init at +-2 sigma, drawn in fp32 and cast to
    ``dtype``, on the generator's device (the JAX package's
    ``dense_init``; same law, other draws)."""
    std = scale / max(shape[0], 1) ** 0.5
    t = torch.empty(shape, device=generator.device)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    return t.to(dtype)


def embed_init(shape, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * 0.02).to(dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """The parameters' dtype, ``cfg.param_dtype`` (fp32 unless a config,
    such as grok-1-314b's, says otherwise)."""
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# norms and rotary embedding
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, pd = cfg.d_model, param_dtype(cfg)
        self.kind = cfg.norm
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=pd))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=pd)) \
            if cfg.norm == "layernorm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.scale, self.bias, x, self.kind)


def apply_norm(scale: torch.Tensor, bias: Optional[torch.Tensor],
               x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """RMS or layer norm with fp32 statistics; the normalization is applied
    in ``x.dtype`` with fp32 factors cast to it, as in the JAX package."""
    d = x.shape[-1]
    xf = x.float()
    ms = (xf * xf).sum(-1, keepdim=True) / d
    if kind == "layernorm":
        mu = xf.sum(-1, keepdim=True) / d
        inv = torch.rsqrt(ms - mu * mu + eps)
        w = inv * scale.float()
        b = bias.float() - mu * w
        return (x * w.to(x.dtype) + b.to(x.dtype)).to(x.dtype)
    if kind != "rmsnorm":
        raise ValueError(f"unknown norm {kind!r}")
    inv = torch.rsqrt(ms + eps)
    return (x * (inv * scale.float()).to(x.dtype)).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (...,
    seq).  Rotated in fp32, then cast back."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nh, nkv = cfg.num_heads, cfg.num_kv_heads
        dev, pd = generator.device, param_dtype(cfg)
        self.wq = nn.Parameter(dense_init((d, nh, hd), generator, dtype=pd))
        self.wk = nn.Parameter(dense_init((d, nkv, hd), generator, dtype=pd))
        self.wv = nn.Parameter(dense_init((d, nkv, hd), generator, dtype=pd))
        self.wo = nn.Parameter(dense_init((nh, hd, d), generator, dtype=pd))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(nh, hd, device=dev, dtype=pd))
            self.bk = nn.Parameter(torch.zeros(nkv, hd, device=dev, dtype=pd))
            self.bv = nn.Parameter(torch.zeros(nkv, hd, device=dev, dtype=pd))
        else:
            self.bq = self.bk = self.bv = None


def _qkv(p: Attention, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = x.dtype
    q = psg.einsum("bsd,dnh->bsnh", x, p.wq.to(dt))
    k = psg.einsum("bsd,dnh->bsnh", x, p.wk.to(dt))
    v = psg.einsum("bsd,dnh->bsnh", x, p.wv.to(dt))
    if p.bq is not None:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    return q, k, v


class SoftmaxLowp(torch.autograd.Function):
    """Row softmax with fp32 statistics and bf16 probabilities (the JAX
    package's ``_softmax_lowp``); the backward is ``w * (g - sum(g * w))``
    with the inner product in fp32.  Only the bf16 probabilities are saved."""

    @staticmethod
    def forward(ctx, scores):
        e = scores - scores.amax(dim=-1, keepdim=True)
        e.exp_()
        e.div_(e.sum(dim=-1, keepdim=True))
        w = e.to(torch.bfloat16)
        ctx.save_for_backward(w)
        return w

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        wf = w.float()
        gf = g.to(torch.float32, copy=True)
        gw = (gf * wf).sum(dim=-1, keepdim=True)
        return gf.sub_(gw).mul_(wf)


def causal_mask(S: int, T: int, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(S, T) bool: query i attends key j iff j <= i + offset and, with a
    window, j > i + offset - window."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B,S,nh,hd), k/v (B,T,nkv,hd), mask (S,T) bool, or a per-row
    (B,1,S,1,T) one (the decode ring's) -> (B,S,nh,hd).  GQA groups the
    query heads over the kv heads by reshape."""
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    qf = q.reshape(B, S, nkv, nh // nkv, hd)
    # bf16 products are exact in fp32: this is the fp32-accumulated product
    scores = torch.einsum("bsngh,btnh->bnsgt", qf.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:
        m = mask[:, None, :] if mask.dim() == 2 else mask
        scores = scores.masked_fill(~m, -1e30)
    w = SoftmaxLowp.apply(scores)
    out = torch.einsum("bnsgt,btnh->bsngh", w.to(v.dtype), v)
    return out.reshape(B, S, nh, hd)


def _sdpa_qchunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Causal (and windowed) attention one chunk of ``ATTN_Q_CHUNK``
    queries at a time against the full keys: the JAX package's
    ``_sdpa_qchunked``.  The queries are padded to a chunk multiple (the
    padded rows attend causally past the end and are sliced off), and each
    chunk is checkpointed, so that the backward recomputes its scores and
    only one chunk's ``(B, nkv, L, g, T)`` fp32 scores are live at a time,
    as under the JAX package's ``jax.checkpoint``."""
    B, S, nh, hd = q.shape
    L = ATTN_Q_CHUNK
    pad = (-S) % L
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    T = k.shape[1]

    def one_chunk(qi, c):
        mask = causal_mask(L, T, c * L, cfg.sliding_window, q.device)
        return _sdpa(qi, k, v, mask)

    out = torch.cat([
        checkpoint(one_chunk, qi, c, use_reentrant=False,
                   preserve_rng_state=False)
        for c, qi in enumerate(q.split(L, dim=1))], dim=1)
    return out[:, :S] if pad else out


def attention_path(cfg: ModelConfig, psg_cfg, S: int,
                   prefer_chunked: bool = False) -> str:
    """The path the JAX package's ``attention_fwd`` takes for ``S`` tokens
    under ``psg_cfg`` (``None``: PSG off): ``"flash"`` when the config
    turns the flash kernels on and there is no sliding window; else
    ``"query-chunked"`` above ``ATTN_CHUNK_THRESHOLD`` tokens, or from
    ``2 * ATTN_Q_CHUNK`` with ``prefer_chunked`` (the eval forward); else
    ``"materialized"``."""
    if cfg.sliding_window == 0 and fused_attention_active(psg_cfg):
        return "flash"
    if S > ATTN_CHUNK_THRESHOLD or (prefer_chunked and S >= 2 * ATTN_Q_CHUNK):
        return "query-chunked"
    return "materialized"


def attention_fwd(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  prefer_chunked: bool = False,
                  causal: bool = True, return_kv: bool = False):
    """Causal (and windowed) self-attention over a full sequence, on
    :func:`attention_path`'s path under the active PSG config; the
    materialized softmax takes the causal-and-window mask whole.
    ``causal=False`` (the encoder) is the materialized softmax with no
    mask, never flash nor chunked, as in the JAX package.  ``return_kv``
    also returns the RoPE'd ``(k, v)`` (B, S, nkv, hd), what
    :func:`fill_kv_cache` hands to decode."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    path = attention_path(cfg, psg.active_config(), S, prefer_chunked) \
        if causal else "unmasked"
    if path == "unmasked":
        out = _sdpa(q, k, v, None)
    elif path == "flash":
        out = psg.attention(q, k, v, causal=True)
    elif path == "query-chunked":
        out = _sdpa_qchunked(q, k, v, cfg)
    else:
        out = _sdpa(q, k, v, causal_mask(S, S, 0, cfg.sliding_window,
                                         x.device))
    y = psg.einsum("bsnh,nhd->bsd", out, p.wo.to(x.dtype))
    return (y, (k, v)) if return_kv else y


# ---------------------------------------------------------------------------
# KV cache (serving)
# ---------------------------------------------------------------------------


def kv_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Slots of a layer's cache: ``max_len``, or with a sliding window a
    ring of ``min(max_len, window)``."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 \
        else max_len


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero ``(k, v)`` caches, each (batch, :func:`kv_cache_len`, nkv,
    hd)."""
    shape = (batch, kv_cache_len(cfg, max_len), cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def fill_kv_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                  max_len: int, dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode caches from a prefill's k/v (B, S, nkv, hd): the last
    ``min(S, T)`` positions at slots ``abs % T``, the layout
    :func:`attention_decode`'s wrap-aware mask expects."""
    S = k.shape[1]
    T = kv_cache_len(cfg, max_len)
    kc, vc = init_kv_cache(cfg, k.shape[0], max_len, dtype, k.device)
    idx_abs = torch.arange(S - min(S, T), S, device=k.device)
    kc[:, idx_abs % T] = k[:, idx_abs].to(dtype)
    vc[:, idx_abs % T] = v[:, idx_abs].to(dtype)
    return kc, vc


def attention_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                     kv_cache: Tuple[torch.Tensor, torch.Tensor],
                     cache_len: torch.Tensor
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """One token: x (B, 1, d), caches (B, T, nkv, hd), ``cache_len`` (B,)
    int, each row's absolute position.  The new k/v are RoPE'd at that
    position and written into the caches in place at slot ``cache_len %
    T`` (device-side indices: nothing is read to the host); a key is
    valid if its slot was written and, with a window, its absolute
    position is within the window.  Returns ``(y, (kc, vc))``, the caches
    the same tensors."""
    kc, vc = kv_cache
    B, T = kc.shape[:2]
    pos = cache_len[:, None]                              # (B, 1)
    q, k, v = _qkv(p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    slot = (cache_len % T)[:, None]
    at = slot[:, :, None, None].expand(B, 1, *kc.shape[2:])
    kc.scatter_(1, at, k.to(kc.dtype))
    vc.scatter_(1, at, v.to(vc.dtype))
    idx = torch.arange(T, device=kc.device)[None, :]      # ring slots
    wraps = pos + 1 > T
    abs_pos = torch.where(wraps, pos - (slot - idx) % T, idx)
    valid = idx < (pos + 1).clamp(max=T)
    if cfg.sliding_window > 0:
        valid &= abs_pos > pos - cfg.sliding_window
    out = _sdpa(q, kc, vc, valid[:, None, None, None, :]).to(x.dtype)
    return torch.einsum("bsnh,nhd->bsd", out, p.wo.to(x.dtype)), (kc, vc)


def cross_attention_fwd(p: Attention, x: torch.Tensor, memory: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """The decoder's attention over the encoder's output ``memory`` (B, T,
    d): no mask, no RoPE, plain ``torch.einsum`` projections (no PSG, as
    the JAX package's ``cross_attention_fwd``)."""
    dt = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, p.wq.to(dt))
    k = torch.einsum("btd,dnh->btnh", memory, p.wk.to(dt))
    v = torch.einsum("btd,dnh->btnh", memory, p.wv.to(dt))
    out = _sdpa(q, k, v, None)
    return torch.einsum("bsnh,nhd->bsd", out, p.wo.to(dt))


# ---------------------------------------------------------------------------
# MLP (optionally gated)
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu, "relu": F.relu,
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 d_ff: int = 0):
        """``d_ff`` (default ``cfg.d_ff``): a shared expert's width."""
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dev, pd = generator.device, param_dtype(cfg)
        self.w_up = nn.Parameter(dense_init((d, f), generator, dtype=pd))
        self.w_down = nn.Parameter(dense_init((f, d), generator, dtype=pd))
        self.w_gate = nn.Parameter(dense_init((d, f), generator, dtype=pd)) \
            if cfg.glu else None
        if cfg.mlp_bias:
            self.b_up = nn.Parameter(torch.zeros(f, device=dev, dtype=pd))
            self.b_down = nn.Parameter(torch.zeros(d, device=dev, dtype=pd))
        else:
            self.b_up = self.b_down = None


def mlp_fwd(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    act = _ACTS[cfg.act]
    up = psg.matmul(x, p.w_up.to(dt))
    if p.b_up is not None:
        up = up + p.b_up.to(dt)
    h = act(up) * psg.matmul(x, p.w_gate.to(dt)) if p.w_gate is not None \
        else act(up)
    y = psg.matmul(h, p.w_down.to(dt))
    if p.b_down is not None:
        y = y + p.b_down.to(dt)
    return y
