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
from repro_torch.distributed import sharding

ATTN_Q_CHUNK = 512               # queries per chunk of the chunked path
ATTN_CHUNK_THRESHOLD = 8192     # chunk the queries above this many tokens
# the materialized softmax's probabilities (the JAX package's
# ``_softmax_lowp``); a test that holds two summation orders of one program
# to fp32 rounding keeps them in fp32, where bf16 would round a probability
# within an fp32 rounding of a bf16 boundary one way in one order and the
# other way in the other
PROBS_DTYPE = torch.bfloat16


class MetaGenerator:
    """The generator of a model built on the ``meta`` device: its inits
    draw nothing and allocate nothing (the counterpart of the JAX
    package's ``jax.eval_shape`` of an init)."""

    device = torch.device("meta")


def init_generator(seed: int, device=None):
    """``torch.Generator(device)`` seeded with ``seed`` (default: the
    CPU's), or a :class:`MetaGenerator` on the ``meta`` device (``device``
    or, without one, the default device: inside ``torch.device("meta")``)."""
    dev = torch.device(device or "cpu")
    if dev.type == "meta" or (device is None and
                              torch.get_default_device().type == "meta"):
        return MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


def dense_init(shape, generator: torch.Generator, scale: float = 1.0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fan-in truncated-normal init at +-2 sigma, drawn in fp32 and cast to
    ``dtype``, on the generator's device (the JAX package's
    ``dense_init``; same law, other draws); an empty ``meta`` tensor for a
    :class:`MetaGenerator`."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    std = scale / max(shape[0], 1) ** 0.5
    t = torch.empty(shape, device=generator.device)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    return t.to(dtype)


def embed_init(shape, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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
        w = e.to(PROBS_DTYPE)
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
    w = SoftmaxLowp.apply(_scores(q, k, mask))
    return _weigh(w, v, q.shape)


def _scores(q: torch.Tensor, k: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`_sdpa`'s fp32 scores (B, nkv, S, group, T), masked to
    -1e30."""
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    qf = q.reshape(B, S, nkv, nh // nkv, hd)
    # bf16 products are exact in fp32: this is the fp32-accumulated product
    scores = torch.einsum("bsngh,btnh->bnsgt", qf.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:
        m = mask[:, None, :] if mask.dim() == 2 else mask
        scores = scores.masked_fill(~m, -1e30)
    return scores


def _weigh(w: torch.Tensor, v: torch.Tensor, shape) -> torch.Tensor:
    """:func:`_sdpa`'s output: the probabilities ``w`` over ``v``'s keys,
    in ``v``'s dtype, shaped as the queries ``shape``."""
    out = torch.einsum("bnsgt,btnh->bsngh", w.to(v.dtype), v)
    return out.reshape(shape)


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
    if sharding.spmd(x):
        if return_kv:       # serving's prefill is not partitioned
            raise NotImplementedError("return_kv on DTensors")
        return _attention_tp(p, x, cfg, prefer_chunked, causal)
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


def _attention_tp(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  prefer_chunked: bool = False, causal: bool = True,
                  memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`attention_fwd` (with ``memory``, :func:`cross_attention_fwd`)
    on ``DTensor``s, tensor-parallel: the weights cast to the activation
    dtype, each kv head's repeated over its query heads, gathered whole but
    for the heads, sharded over the model axis where they divide it; each
    rank runs the plain function on its batch rows and heads
    (``sharding.run_local``); the output projection's sum over heads, a
    partial result over the model axis, is all-reduced at once."""
    dt, g = x.dtype, cfg.num_heads // cfg.num_kv_heads
    names = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv")
                                        if p.bq is not None else ())
    ws = [getattr(p, n).to(dt) for n in names]
    if g > 1:           # wk, wv (d, nkv, hd) and bk, bv (nkv, hd)
        ws = [w.repeat_interleave(g, dim=-2) if n[1] in "kv" else w
              for n, w in zip(names, ws)]
    rows = ("batch", None, None)
    specs = [rows] + [
        ("heads", None, None) if n == "wo" else
        (None, "heads", None) if n[0] == "w" else ("heads", None)
        for n in names]

    def local(x, *w):
        lp = dict(bq=None, bk=None, bv=None)
        lp.update(zip(names, w))
        if memory is None:
            return attention_fwd(LocalWeights(**lp), x, cfg, prefer_chunked,
                                 causal)
        return cross_attention_fwd(LocalWeights(**lp), x, w[len(names)], cfg)
    args = [x] + ws + ([] if memory is None else [memory])
    specs += [] if memory is None else [rows]
    # the sum over heads reduced at once: the stream stays batch-sharded
    return sharding.hint(sharding.run_local(
        local, args, specs, rows, partial=("heads", cfg.num_heads)), *rows)


class LocalWeights:
    """Named local weights standing in for a module's parameters."""

    def __init__(self, **w):
        self.__dict__.update(w)


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
    pos = cache_len[:, None]                              # (B, 1)
    q, k, v = _qkv(p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if sharding.spmd(kc):
        out = _decode_sharded(q, k, v, kc, vc, cache_len, cfg)
    else:
        valid = _write_kv(kc, vc, k, v, cache_len, cfg.sliding_window)
        out = _sdpa(q, kc, vc, valid[:, None, None, None, :])
    out = out.to(x.dtype)
    return torch.einsum("bsnh,nhd->bsd", out, p.wo.to(x.dtype)), (kc, vc)


def _write_kv(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, cache_len: torch.Tensor, window: int,
              T: int = 0, t0: int = 0) -> torch.Tensor:
    """Write ``k``, ``v`` (B, 1, nkv, hd) in place at ring slot
    ``cache_len % T`` of the caches; returns the (B, n) validity of their
    slots (written, and within the window).  The caches may be a shard:
    the ``n`` slots from ``t0`` of a ring of ``T``, where a row whose slot
    lies in another shard keeps its keys."""
    B, n = kc.shape[:2]
    T = T or n
    pos = cache_len[:, None]
    slot = (cache_len % T)[:, None]
    at = (slot - t0).clamp(0, n - 1)[:, :, None, None] \
        .expand(B, 1, *kc.shape[2:])
    for c, new in ((kc, k), (vc, v)):
        new = new.to(c.dtype)
        if n != T:
            inside = (slot >= t0) & (slot < t0 + n)
            new = torch.where(inside[:, :, None, None], new, c.gather(1, at))
        c.scatter_(1, at, new)
    idx = torch.arange(t0, t0 + n, device=kc.device)[None, :]   # ring slots
    wraps = pos + 1 > T
    abs_pos = torch.where(wraps, pos - (slot - idx) % T, idx)
    valid = idx < (pos + 1).clamp(max=T)
    if window > 0:
        valid &= abs_pos > pos - window
    return valid


def _decode_sharded(q, k, v, kc, vc, cache_len, cfg):
    """:func:`attention_decode`'s cache write and attention on
    ``DTensor``s, on each rank's shards (``sharding.run_local``), the
    caches kept in their placements and written in place.  A cache whose
    kv heads are sharded runs the plain write and :func:`_sdpa` on its
    heads; one whose slots are sharded over the model axis writes the slot
    where it lies and attends as a split softmax: each rank's scores over
    its slots, their max and sum partial results over the slots, the
    output a partial sum (the few bytes a row of the reductions move, not
    the cache)."""
    T = kc.shape[1]
    axis = sharding.sharded_by(kc, "model")
    rows = ("batch", None, None, None)
    if axis != 1:
        heads = ("batch", None, "heads" if axis == 2 else None, None)

        def local(q, k, v, kc, vc, cl):
            valid = _write_kv(kc, vc, k, v, cl, cfg.sliding_window)
            return _sdpa(q, kc, vc, valid[:, None, None, None, :])
        return sharding.run_local(local, (q, k, v, kc, vc, cache_len),
                                  (heads,) * 5 + (("batch",),), heads,
                                  inplace=(3, 4))
    t0 = sharding.shard_start(kc, 1)
    slots = ("batch", "seq", None, None)
    s_spec = ("batch", None, None, None, "seq")
    r5 = ("batch", None, None, None, None)
    B, S, nh, hd = q.shape
    nkv = kc.shape[2]

    def scores(q, k, v, kc, vc, cl):
        valid = _write_kv(kc, vc, k, v, cl, cfg.sliding_window, T, t0)
        return _scores(q, kc, valid[:, None, None, None, :])
    s = sharding.run_local(scores, (q, k, v, kc, vc, cache_len),
                           (rows,) * 3 + (slots,) * 2 + (("batch",),),
                           s_spec, out_shape=(B, nkv, S, nh // nkv, T),
                           inplace=(3, 4))
    # SoftmaxLowp's forward, its max and sum over the shards
    m = sharding.hint(sharding.run_local(
        lambda s: s.amax(dim=-1, keepdim=True), (s,), (s_spec,), r5,
        partial=("seq", T, "max")), *r5)
    z = sharding.hint(sharding.run_local(
        lambda s, m: (s - m).exp().sum(dim=-1, keepdim=True), (s, m),
        (s_spec, r5), r5, partial=("seq", T)), *r5)
    return sharding.hint(sharding.run_local(
        lambda s, m, z, vc: _weigh(((s - m).exp() / z).to(PROBS_DTYPE),
                                   vc, (s.shape[0], S, nh, hd)),
        (s, m, z, vc), (s_spec, r5, r5, slots), rows, partial=("seq", T)),
        *rows)


def cross_attention_fwd(p: Attention, x: torch.Tensor, memory: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """The decoder's attention over the encoder's output ``memory`` (B, T,
    d): no mask, no RoPE, plain ``torch.einsum`` projections (no PSG, as
    the JAX package's ``cross_attention_fwd``); tensor-parallel on
    ``DTensor``s, as :func:`attention_fwd`."""
    if sharding.spmd(x):
        return _attention_tp(p, x, cfg, memory=memory)
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
    if sharding.spmd(x):
        return _mlp_tp(p, x, cfg)
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


def _mlp_tp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`mlp_fwd` on ``DTensor``s, tensor-parallel: the weights cast
    to the activation dtype and gathered whole but for ``d_ff``, sharded
    over the model axis where it divides it; each rank runs the plain
    :func:`mlp_fwd` on its rows (``sharding.run_local``), the down
    projection's sum over ``d_ff`` a partial result, all-reduced at once;
    its bias is added after the sum."""
    dt = x.dtype
    names = ("w_up", "w_down") + (("w_gate",) if p.w_gate is not None
                                  else ()) + (("b_up",) if p.b_up is not None
                                              else ())
    spec = {"w_up": (None, "mlp"), "w_down": ("mlp", None),
            "w_gate": (None, "mlp"), "b_up": ("mlp",)}
    rows = ("batch",) + (None,) * (x.ndim - 1)

    def local(x, *w):
        lp = dict(w_gate=None, b_up=None, b_down=None)
        lp.update(zip(names, w))
        return mlp_fwd(LocalWeights(**lp), x, cfg)
    y = sharding.hint(sharding.run_local(
        local, [x] + [getattr(p, n).to(dt) for n in names],
        [rows] + [spec[n] for n in names], rows,
        partial=("mlp", p.w_up.shape[1])), *rows)
    if p.b_down is not None:
        y = y + p.b_down.to(dt)
    return y
