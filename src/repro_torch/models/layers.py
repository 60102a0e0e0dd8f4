"""Transformer layers: norms, rotary embedding, GQA attention, and the
(gated) MLP.

The counterpart of the JAX package's ``models/layers.py`` for dense
training.  Parameters are fp32 ``nn.Parameter``s in the JAX layouts (``wq``
``(d, nh, hd)``, ``wo`` ``(nh, hd, d)``, MLP weights ``(in, out)``) and are
cast to the activation dtype inside each call, so a JAX tree loads as it
is (``repro_torch.convert``).  Every weight matmul goes through
``core/psg.matmul``/``einsum``, so under an active PSG config it runs the
PSG matmul kernels.  Attention takes one of two paths, chosen as the JAX
package chooses: under a PSG config with ``fused_attention=True``, the
flash kernels with the PSG dk/dv backward (``core/psg.attention``), which
keep every ``(S, T)`` tile out of device memory; otherwise the
materialized softmax, scores in fp32 and probabilities in bf16
(:class:`SoftmaxLowp`), up to 8192 tokens (the query-chunked path above
that is not ported).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import psg
from repro_torch.core.config import ModelConfig, fused_attention_active

ATTN_CHUNK_THRESHOLD = 8192     # the JAX package chunks queries above this


def dense_init(shape, generator: torch.Generator, scale: float = 1.0
               ) -> torch.Tensor:
    """Fan-in truncated-normal init at +-2 sigma, on the generator's
    device (the JAX package's ``dense_init``; same law, other draws)."""
    std = scale / max(shape[0], 1) ** 0.5
    t = torch.empty(shape, device=generator.device)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    return t


def embed_init(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * 0.02


# ---------------------------------------------------------------------------
# norms and rotary embedding
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.kind = cfg.norm
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device)) \
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
        dev = generator.device
        self.wq = nn.Parameter(dense_init((d, nh, hd), generator))
        self.wk = nn.Parameter(dense_init((d, nkv, hd), generator))
        self.wv = nn.Parameter(dense_init((d, nkv, hd), generator))
        self.wo = nn.Parameter(dense_init((nh, hd, d), generator))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(nh, hd, device=dev))
            self.bk = nn.Parameter(torch.zeros(nkv, hd, device=dev))
            self.bv = nn.Parameter(torch.zeros(nkv, hd, device=dev))
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


def causal_mask(S: int, T: int, device=None) -> torch.Tensor:
    """(S, T) bool: query i attends key j iff j <= i."""
    return torch.ones(S, T, dtype=torch.bool, device=device).tril()


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B,S,nh,hd), k/v (B,T,nkv,hd), mask (S,T) bool -> (B,S,nh,hd).
    GQA groups the query heads over the kv heads by reshape."""
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    qf = q.reshape(B, S, nkv, nh // nkv, hd)
    # bf16 products are exact in fp32: this is the fp32-accumulated product
    scores = torch.einsum("bsngh,btnh->bnsgt", qf.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, :], -1e30)
    w = SoftmaxLowp.apply(scores)
    out = torch.einsum("bnsgt,btnh->bsngh", w.to(v.dtype), v)
    return out.reshape(B, S, nh, hd)


def attention_fwd(p: Attention, x: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """Causal self-attention over a full sequence (training)."""
    B, S, _ = x.shape
    fused = cfg.sliding_window == 0 and \
        fused_attention_active(psg.active_config())
    if not fused and S > ATTN_CHUNK_THRESHOLD:
        raise NotImplementedError(
            f"sequence {S} > {ATTN_CHUNK_THRESHOLD} needs the query-chunked "
            "attention path, which is not ported")
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if fused:
        out = psg.attention(q, k, v, causal=True)
    else:
        out = _sdpa(q, k, v, causal_mask(S, S, x.device))
    return psg.einsum("bsnh,nhd->bsd", out, p.wo.to(x.dtype))


# ---------------------------------------------------------------------------
# MLP (optionally gated)
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu, "relu": F.relu,
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dev = generator.device
        self.w_up = nn.Parameter(dense_init((d, f), generator))
        self.w_down = nn.Parameter(dense_init((f, d), generator))
        self.w_gate = nn.Parameter(dense_init((d, f), generator)) \
            if cfg.glu else None
        if cfg.mlp_bias:
            self.b_up = nn.Parameter(torch.zeros(f, device=dev))
            self.b_down = nn.Parameter(torch.zeros(d, device=dev))
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
